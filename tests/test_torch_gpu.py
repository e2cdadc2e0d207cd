"""The port's CUDA kernels and its cuda backend against their plain
PyTorch versions on the card.

Every test here carries the ``gpu`` marker and skips inside its body when
CUDA is unavailable.  The file imports neither jax nor volcano_tpu, so it
also runs on a machine with a card but without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Decision outputs must be equal; float state is held to rtol=1e-6 (the
sums are exact for these inputs, so bit-equality is expected).
"""

import numpy as np
import pytest
import torch

from volcano_tpu_torch import interop
from volcano_tpu_torch.scheduler import kernels as K
from volcano_tpu_torch.scheduler import victim_kernels as VK
from volcano_tpu_torch.scheduler.conf import full_conf
from volcano_tpu_torch.scheduler.scheduler import Scheduler
from volcano_tpu_torch.scheduler.simargs import (
    BATCH_EDGE_CASES,
    EXACT_EDGE_CASES,
    GROUP_EDGE_CASES,
    PORTSEL_KEYS,
    ROUNDS_EDGE_CASES,
    WALK_EDGE_CASES,
    add_releasing,
    build_batch_edge_args,
    build_exact_edge_args,
    build_group_edge_args,
    build_portsel_args,
    build_reclaim_abort_sim,
    build_rounds_edge_args,
    build_sim_args,
    build_storm_sim,
    build_victim_sim,
    build_volsel_args,
    build_walk_edge_args,
    build_water_fill_args,
    storm_inputs,
)

# the plain versions are many small ops: one intra-op thread each, so that
# parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

DECISIONS = ("task_node", "task_kind", "task_seq", "ready", "dropped", "steps")
POLICIES = [
    dict(job_key_order=("priority", "gang", "drf"), use_gang_ready=True, use_proportion=True),
    dict(job_key_order=("drf", "gang", "priority"), use_gang_ready=False, use_proportion=False),
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(dev, seed, releasing):
    a = build_sim_args(14, 64, 16, n_queues=3, seed=seed, n_classes=3, class_fill=0.6)
    if releasing:
        add_releasing(a, seed)
    a["node_max_tasks"][:] = 4
    return {k: torch.from_numpy(v).to(dev) for k, v in a.items()}


def _water_fill_inputs(a):
    return (a["queue_weight"], a["queue_request"], a["total"], a["eps"],
            a["queue_participates"])


def _assert_same(out_k, out_p):
    for name in K.SolveOut._fields:
        x, y = getattr(out_k, name), getattr(out_p, name)
        if name in DECISIONS:
            assert torch.equal(x.to(y.dtype), y), name
        else:
            torch.testing.assert_close(x, y, rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(3))
def test_gpu_water_fill_matches_plain(seed):
    dev = _cuda()
    a = _args(dev, seed, False)
    a["queue_request"][0] *= 0.25
    K.reset_launches()
    des = K.water_fill(*_water_fill_inputs(a))
    assert K.LAUNCHES["water_fill"] == 1
    assert torch.equal(des, K.water_fill_plain(*_water_fill_inputs(a)))


@pytest.mark.gpu
def test_gpu_water_fill_raises_at_round_cap(monkeypatch):
    dev = _cuda()
    a = _args(dev, 0, False)
    a["queue_request"][0] *= 0.25  # one queue capped: needs a second round
    monkeypatch.setattr(K, "WATER_FILL_MAX_ROUNDS", 1)
    with pytest.raises(RuntimeError, match="no convergence"):
        # the wrapper does not wait for its kernel: the check raises
        K.water_fill(*_water_fill_inputs(a))
        K.water_fill_check()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["config5", "queues_128", "cells_2048", "staggered_1024",
                                  "staggered_4096", "staggered_8192"])
def test_gpu_water_fill_shapes_bit_for_bit(case):
    """K1 equal to its plain version bit for bit at the main path's shapes
    and above 1,024 queues (two levels of summing windows, up to the
    8,192-cell cap), and no allocation but the returned shares after the
    first call at a shape (the round words sit in the device's workspace)."""
    dev = _cuda()
    wf = tuple(torch.from_numpy(build_water_fill_args(case)[k]).to(dev)
               for k in ("queue_weight", "queue_request", "total", "eps",
                         "queue_participates"))
    K.water_fill_check()
    des = K.water_fill(*wf)
    K.water_fill_check()
    assert torch.equal(des, K.water_fill_plain(*wf))
    torch.cuda.synchronize()
    for _ in range(2 * K._WF_SLOTS):  # every slot of the workspace taken again
        before = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        again = K.water_fill(*wf)
        assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] - before == 1
    K.water_fill_check()
    assert torch.equal(again, des)


def _capped_shares(dev, monkeypatch, Q=4):
    """K1 on a [Q, 2] fill that needs two rounds, launched with a cap of
    one: the shares come back, the error waits for a check."""
    monkeypatch.setattr(K, "WATER_FILL_MAX_ROUNDS", 1)
    req = torch.tensor([[250.0, float(1 << 28)]] + [[64000.0, float(1 << 36)]] * (Q - 1),
                       device=dev)
    des = K.water_fill(torch.ones(Q, device=dev), req,
                       torch.tensor([16000.0, float(1 << 35)], device=dev),
                       torch.tensor([10.0, float(10 << 20)], device=dev),
                       torch.ones(Q, dtype=torch.bool, device=dev))
    monkeypatch.setattr(K, "WATER_FILL_MAX_ROUNDS", 4096)
    return des


@pytest.mark.gpu
@pytest.mark.parametrize("consumer", ["K2", "K3", "K7", "K12a"])
def test_gpu_round_cap_reaches_the_consumer(consumer, monkeypatch):
    """The round-cap error of a K1 launch surfaces in the wrapper of the
    first kernel that consumes its shares, before that wrapper returns a
    decision."""
    from volcano_tpu_torch.parallel import sharded as S

    dev = _cuda()
    K.water_fill_check()
    if consumer in ("K2", "K3", "K12a"):
        a = _args(dev, 0, False)
        des = _capped_shares(dev, monkeypatch, a["queue_alloc_init"].shape[0])
        args = {k: (des if k == "queue_deserved" else a[k]) for k in K._SOLVE_ARGS}
        with pytest.raises(RuntimeError, match="no convergence"):
            if consumer == "K2":
                K.allocate_solve(*args.values(), 1.0, 1.0)
            elif consumer == "K3":
                K.allocate_solve_batch(*args.values(), 1.0, 1.0)
            else:
                mesh = S.LocalMesh(2, dev)
                planes = {k: S.split_rows(mesh, k, args[k]) for k in K.NODE_PLANES}
                repl = {k: args[k] for k in K._SOLVE_ARGS if k not in K.NODE_PLANES}
                S.sharded_solve(mesh, planes, repl, 1.0, 1.0)
    else:
        c_np, s_np = build_victim_sim(16, 120, 10, seed=3)
        c, s = interop.victim_from_arrays(c_np, s_np, dev)
        des = _capped_shares(dev, monkeypatch, c.queue_deserved.shape[0])
        c = c._replace(queue_deserved=des)
        with pytest.raises(RuntimeError, match="no convergence"):
            VK.victim_step(c, s, torch.tensor([1000.0, float(1 << 30)], device=dev), 0, 0, 0)
    K.water_fill_check()  # the error was raised once, and nothing pends


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("seed,releasing", [(0, False), (1, True), (2, True)])
@pytest.mark.parametrize("policy", range(len(POLICIES)))
def test_gpu_solve_kernel_matches_plain(batch, seed, releasing, policy):
    dev = _cuda()
    a = _args(dev, seed, releasing)
    des = K.water_fill(*_water_fill_inputs(a))
    args = {k: (des if k == "queue_deserved" else a[k]) for k in K._SOLVE_ARGS}
    wrap = K.allocate_solve_batch if batch else K.allocate_solve
    plain = K.allocate_solve_batch_plain if batch else K.allocate_solve_plain
    chunks = dict(m_chunk=4, p_chunk=3) if batch and seed else {}
    K.reset_launches()
    out_k = wrap(*args.values(), 1.0, 1.0, **POLICIES[policy], **chunks)
    assert K.LAUNCHES["allocate_solve_batch" if batch else "allocate_solve"] == 1
    out_p = plain(**args, w_least=1.0, w_balanced=1.0, **POLICIES[policy], **chunks)
    _assert_same(out_k, out_p)
    packed = K.pack_outputs(out_k)
    assert packed.data_ptr() == out_k.task_node.data_ptr()  # the kernel's buffer, no copy
    assert torch.equal(packed, K.pack_outputs(out_p))


def _spec(seed, n_nodes=12, n_jobs=16):
    rng = np.random.default_rng(seed)
    spec = {"queues": [{"name": "qa", "weight": 2}, {"name": "qb", "weight": 1},
                       {"name": "default", "weight": 1}],
            "nodes": [{"name": f"n{i:02d}", "allocatable": {
                "cpu": str(int(rng.choice([4, 8]))),
                "memory": f"{int(rng.choice([8, 16]))}Gi", "pods": 8}}
                for i in range(n_nodes)],
            "podgroups": [], "pods": []}
    if seed == 2:  # a scalar resource as a third dimension
        for node in spec["nodes"]:
            node["allocatable"]["accelerator"] = str(int(rng.integers(0, 3)))
    for j in range(n_jobs):
        n = int(rng.integers(1, 6))
        spec["podgroups"].append({"name": f"job{j}", "min_member": int(rng.integers(1, n + 1)),
                                  "queue": str(rng.choice(["qa", "qb"])), "phase": "Pending"})
        for t in range(n):
            res = {"cpu": str(rng.choice(["500m", "1", "2"])),
                   "memory": f"{int(rng.choice([512, 1024, 2048]))}Mi"}
            if seed == 2 and t % 2:
                res["accelerator"] = "1"
            spec["pods"].append({"name": f"job{j}-{t}", "group": f"job{j}", "resources": res})
    return spec


@pytest.mark.gpu
@pytest.mark.parametrize("solve_mode", ["exact", "batch"])
@pytest.mark.parametrize("seed", range(3))
def test_gpu_scheduler_binds_equal_cpu(solve_mode, seed):
    """The cuda backend (the kernels) binds exactly what the cpu backend
    (their plain versions) binds, with the same PodGroup phases."""
    _cuda()
    states = []
    for backend in ("cuda", "cpu"):
        store = interop.store_from_spec(_spec(seed))
        conf = full_conf(backend)
        conf.solve_mode = solve_mode
        sched = Scheduler(store, conf=conf)
        K.reset_launches()
        sched.run_once()
        if backend == "cuda":
            assert K.LAUNCHES["allocate_solve_batch" if solve_mode == "batch"
                              else "allocate_solve"] == 1
        states.append((
            {p.meta.key: p.node_name for p in store.list("Pod")},
            {g.meta.key: g.status.phase for g in store.list("PodGroup")},
        ))
    assert states[0] == states[1]
    assert any(states[0][0].values())


# -- K5: the portsel extension -------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("seed,w_podaff", [(0, 1.0), (1, 0.1), (2, 1.0), (3, 0.1)])
def test_gpu_portsel_solve_matches_plain(batch, seed, w_podaff):
    dev = _cuda()
    a = _args(dev, seed, releasing=seed > 0)
    p = build_portsel_args(14, 64, seed=seed, n_jobs=16, w_podaff=w_podaff)
    ps = tuple(p[k] if k == "w_podaff" else torch.from_numpy(p[k]).to(dev) for k in PORTSEL_KEYS)
    des = K.water_fill(*_water_fill_inputs(a))
    args = {k: (des if k == "queue_deserved" else a[k]) for k in K._SOLVE_ARGS}
    wrap = K.allocate_solve_batch if batch else K.allocate_solve
    plain = K.allocate_solve_batch_plain if batch else K.allocate_solve_plain
    chunks = dict(m_chunk=4, p_chunk=3) if batch and seed % 2 else {}
    name = "allocate_solve_batch" if batch else "allocate_solve"
    K.reset_launches()
    out_k = wrap(*args.values(), 1.0, 1.0, portsel=ps, **chunks)
    assert K.LAUNCHES[name] == 1 and K.LAUNCHES[name + "_portsel"] == 1
    out_p = plain(**args, w_least=1.0, w_balanced=1.0, portsel=ps, **chunks)
    _assert_same(out_k, out_p)
    assert int((out_p.task_kind > 0).sum()) > 0


def _dyn_spec(seed, n_nodes=10, n_jobs=12):
    """Residents with labels and host ports, and pending jobs that are
    plain, carry a host port, or require or refuse a labelled neighbour."""
    rng = np.random.default_rng(seed)
    pick = lambda seq: seq[int(rng.integers(len(seq)))]  # noqa: E731
    labels = [{"app": "web"}, {"app": "db"}, {}]
    spec = {"queues": [{"name": "default", "weight": 1}],
            "nodes": [{"name": f"n{i:02d}", "allocatable": {"cpu": "8", "memory": "16Gi",
                                                            "pods": 20}}
                      for i in range(n_nodes)],
            "podgroups": [{"name": "res", "min_member": 1, "queue": "default",
                           "phase": "Running"}],
            "pods": [{"name": f"res-{i}", "group": "res", "phase": "Running",
                      "resources": {"cpu": "1", "memory": "1Gi"}, "labels": pick(labels),
                      "node_name": f"n{i % n_nodes:02d}", "host_ports": [pick([80, 8080])]}
                     for i in range(4)]}
    for j in range(n_jobs):
        kind = pick(["plain", "ports", "aff", "anti"])
        spec["podgroups"].append({"name": f"j{j}", "min_member": 2, "queue": "default",
                                  "phase": "Inqueue"})
        for t in range(3):
            pod = {"name": f"j{j}-{t}", "group": f"j{j}", "labels": pick(labels),
                   "resources": {"cpu": pick(["500m", "1"]), "memory": "1Gi"}}
            if kind == "ports":
                pod["host_ports"] = [pick([80, 8080, 9090])]
            elif kind == "aff":
                pod["pod_affinity"] = [{"app": "web"}]
            elif kind == "anti":
                pod["pod_anti_affinity"] = [pick(labels[:2])]
            spec["pods"].append(pod)
    return spec


@pytest.mark.gpu
@pytest.mark.parametrize("solve_mode", ["exact", "batch"])
@pytest.mark.parametrize("seed", range(2))
def test_gpu_dynamic_scheduler_binds_equal_cpu(solve_mode, seed):
    """On a cluster with dynamic jobs the cuda backend's dynamic pass (K5
    in K2 or K3) binds what the cpu backend's plain versions bind."""
    _cuda()
    states = []
    for backend in ("cuda", "cpu"):
        store = interop.store_from_spec(_dyn_spec(seed))
        conf = full_conf(backend)
        # the dynamic pass alone: preempt beside dynamic jobs runs in the
        # object sub-cycle (test_gpu_residue_subcycle_equals_cpu)
        conf.actions = ["enqueue", "allocate", "backfill"]
        conf.solve_mode = solve_mode
        sched = Scheduler(store, conf=conf)
        K.reset_launches()
        sched.run_once()
        assert "dyn_solve" in sched.fast_cycle.phases
        if backend == "cuda":
            name = "allocate_solve_batch" if solve_mode == "batch" else "allocate_solve"
            assert K.LAUNCHES[name + "_portsel"] == 1
        states.append((
            {p.meta.key: p.node_name for p in store.list("Pod")},
            {g.meta.key: g.status.phase for g in store.list("PodGroup")},
        ))
    assert states[0] == states[1]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(2))
def test_gpu_residue_subcycle_equals_cpu(seed):
    """A best-effort pod on every dynamic job makes those jobs residue: under
    the full conf the fast cycle solves the express jobs on the card (K1,
    then K2 or K3), hands the residue to its object sub-cycle (the numpy
    engine, then backfill and preempt) and binds, evicts and writes what the
    cpu backend's plain versions do."""
    _cuda()
    outs = []
    for backend in ("cuda", "cpu"):
        spec = _dyn_spec(seed)
        dyn = sorted({p["group"] for p in spec["pods"] if p.get("phase") != "Running" and (
            p.get("host_ports") or p.get("pod_affinity") or p.get("pod_anti_affinity"))})
        assert dyn
        spec["pods"] += [{"name": f"be-{g}", "group": g, "resources": {}} for g in dyn]
        store = interop.store_from_spec(spec)
        sched = Scheduler(store, conf=full_conf(backend))
        K.reset_launches()
        sched.run_once()
        fc = sched.fast_cycle
        assert sched.last_path == "fast"
        assert {"subcycle", "residue_vec"} <= set(fc.phases)
        assert set(fc.last_residue_reasons.values()) == {"best-effort"}
        if backend == "cuda":
            assert K.LAUNCHES["water_fill"] >= 1
            assert K.LAUNCHES["allocate_solve"] + K.LAUNCHES["allocate_solve_batch"] >= 1
        outs.append((dict(sched.cache.bind_log), list(sched.cache.evict_log),
                     {g.meta.key: (g.status.phase, [c.message for c in g.status.conditions])
                      for g in store.list("PodGroup")}))
    assert outs[0] == outs[1]
    assert any(k.startswith("default/be-") for k in outs[0][0])


# -- K6: volumes ---------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("with_portsel", [False, True])
@pytest.mark.parametrize("seed,releasing", [(0, False), (1, True), (2, True), (3, True)])
def test_gpu_volsel_solve_matches_plain(seed, releasing, with_portsel):
    """K6 inside K2 (with and without K5) against the plain version: equal
    decisions and final volume state, inputs untouched."""
    dev = _cuda()
    a = _args(dev, seed, releasing)
    des = K.water_fill(*_water_fill_inputs(a))
    args = {k: (des if k == "queue_deserved" else a[k]) for k in K._SOLVE_ARGS}
    vs = interop.volsel_from_payload(build_volsel_args(14, 64, seed=seed, n_jobs=16), dev)
    before = [x.clone() for x in vs]
    ext = {}
    if with_portsel:
        p = build_portsel_args(14, 64, seed=seed, n_jobs=16)
        ext["portsel"] = tuple(p[k] if k == "w_podaff" else torch.from_numpy(p[k]).to(dev)
                               for k in PORTSEL_KEYS)
    K.reset_launches()
    out_k = K.allocate_solve(*args.values(), 1.0, 1.0, volsel=vs, **ext)
    assert K.LAUNCHES["allocate_solve"] == K.LAUNCHES["allocate_solve_volsel"] == 1
    out_p = K.allocate_solve_plain(**args, w_least=1.0, w_balanced=1.0, volsel=vs, **ext)
    _assert_same(out_k, out_p)
    assert torch.equal(out_k.claim_node, out_p.claim_node)
    assert torch.equal(out_k.vol_cap, out_p.vol_cap)
    assert all(torch.equal(x, y) for x, y in zip(vs, before))
    assert int((out_p.task_kind > 0).sum()) > 0


def _vol_spec():
    """A pin bound by a claim, a zone-wide PV, a node-pinned pool two jobs
    contend for, a network pool, a dynamic-class claim and a claim-less
    volume, beside plain jobs."""
    spec = {"queues": [{"name": "default", "weight": 1}],
            "nodes": [{"name": f"n{i}", "labels": {"zone": "a" if i < 2 else "b"},
                       "allocatable": {"cpu": "8", "memory": "16Gi", "pods": 20}}
                      for i in range(8)],
            "storage_classes": [{"name": "local", "provisioner": ""},
                                {"name": "shared", "provisioner": ""}],
            "pvs": [{"name": "pin5", "capacity": "20Gi", "storage_class": "net",
                     "node_affinity": {"kubernetes.io/hostname": "n5"},
                     "claim_ref": "default/b5"},
                    {"name": "zoned", "capacity": "20Gi", "storage_class": "net",
                     "node_affinity": {"zone": "a"}, "claim_ref": "default/bz"},
                    {"name": "loc0", "capacity": "20Gi", "storage_class": "local",
                     "node_affinity": {"kubernetes.io/hostname": "n3"}},
                    {"name": "net0", "capacity": "20Gi", "storage_class": "shared"}],
            "pvcs": [{"name": "b5", "size": "5Gi", "storage_class": "net", "volume_name": "pin5",
                      "phase": "Bound"},
                     {"name": "bz", "size": "5Gi", "storage_class": "net",
                      "volume_name": "zoned", "phase": "Bound"},
                     {"name": "l0", "size": "5Gi", "storage_class": "local"},
                     {"name": "l1", "size": "5Gi", "storage_class": "local"},
                     {"name": "g0", "size": "5Gi", "storage_class": "shared"},
                     {"name": "dyn", "size": "5Gi", "storage_class": "standard"}],
            "podgroups": [], "pods": []}
    for name, n, vols in (("pin", 2, ["b5"]), ("zone", 2, ["bz"]), ("loc0", 2, ["l0"]),
                          ("loc1", 1, ["l1"]), ("net", 2, ["g0"]),
                          ("dyn", 2, ["dyn", "scratch"]), ("plain", 3, [])):
        spec["podgroups"].append({"name": name, "min_member": n, "phase": "Inqueue"})
        for t in range(n):
            spec["pods"].append({"name": f"{name}-{t}", "group": name, "volumes": vols,
                                 "resources": {"cpu": "1", "memory": "1Gi"}})
    return spec


@pytest.mark.gpu
def test_gpu_volume_scheduler_equals_cpu():
    """On a cluster with volume gangs the cuda backend's dynamic pass (K6
    with K5 in K2) binds, phases and binds volumes as the cpu backend's
    plain versions do."""
    _cuda()
    states = []
    for backend in ("cuda", "cpu"):
        store = interop.store_from_spec(_vol_spec())
        sched = Scheduler(store, conf=full_conf(backend))
        K.reset_launches()
        sched.run_once()
        assert "vol_solve" in sched.fast_cycle.phases and "dyn_solve" in sched.fast_cycle.phases
        if backend == "cuda":
            assert K.LAUNCHES["allocate_solve_volsel"] == 1
        provisioned = {pv.meta.name: f"for:{pv.claim_ref}" for pv in store.list("PV")
                       if pv.provisioned}
        states.append((
            {p.meta.key: p.node_name for p in store.list("Pod")},
            {g.meta.key: g.status.phase for g in store.list("PodGroup")},
            {provisioned.get(pv.meta.name, pv.meta.name): pv.claim_ref
             for pv in store.list("PV")},
            {c.meta.key: (c.phase, provisioned.get(c.volume_name, c.volume_name))
             for c in store.list("PVC")},
        ))
    assert states[0] == states[1]
    binds = states[0][0]
    assert {binds["default/pin-0"], binds["default/pin-1"]} == {"n5"}
    assert states[0][3]["default/l0"][0] == "Bound" or states[0][3]["default/l1"][0] == "Bound"


# -- K8-K10: the contention solves ---------------------------------------------

def _victim_flat(out):
    flat = {}
    for name in out._fields:
        part = getattr(out, name)
        if hasattr(part, "_fields"):
            flat.update({f"{name}.{f}": getattr(part, f) for f in part._fields})
        else:
            flat[name] = part
    return flat


def _assert_victims_same(out_k, out_p):
    """Decisions equal; float state bit-equal too (whole-number requests,
    float64 segment sums: see victim_kernels' module note)."""
    fk, fp = _victim_flat(out_k), _victim_flat(out_p)
    for name, x in fk.items():
        y = torch.as_tensor(fp[name], device=x.device)
        assert torch.equal(x.to(y.dtype), y), name


def _storm(dev, kind, seed, **kw):
    c, s, t = build_storm_sim(seed, **kw)
    tc, ts = interop.victim_from_arrays(c, s, dev)
    args = [a if isinstance(a, int) else torch.from_numpy(np.asarray(a)).to(dev)
            for a in storm_inputs(kind, c, s, t)]
    return tc, ts, args


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("use_prop,use_gang", [(True, True), (False, False)])
def test_gpu_reclaim_solve_matches_plain(seed, use_prop, use_gang):
    dev = _cuda()
    c, s, args = _storm(dev, "reclaim", seed)
    kw = dict(use_gang=use_gang, use_prop=use_prop, use_conformance=True,
              order_by_priority=True, has_proportion=seed != 1)
    VK.reset_launches()
    out_k = VK.reclaim_solve(c, s, *args, **kw)
    assert VK.LAUNCHES["reclaim_solve"] == 1
    _assert_victims_same(out_k, VK.reclaim_solve_plain(c, s, *args, **kw))


@pytest.mark.gpu
def test_gpu_reclaim_abort_matches_plain():
    dev = _cuda()
    c, s, t = build_reclaim_abort_sim()
    tc, ts = interop.victim_from_arrays(c, s, dev)
    args = [torch.from_numpy(np.asarray(a)).to(dev) for a in storm_inputs("reclaim", c, s, t)]
    kw = dict(use_gang=False, use_prop=False, use_conformance=False, order_by_priority=True,
              has_proportion=True)
    out_k = VK.reclaim_solve(tc, ts, *args, **kw)
    assert bool(out_k.abort)
    _assert_victims_same(out_k, VK.reclaim_solve_plain(tc, ts, *args, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 5, 9, 29])
@pytest.mark.parametrize("use_drf,gang_pipelined", [(True, True), (False, False)])
def test_gpu_preempt_solve_matches_plain(seed, use_drf, gang_pipelined):
    dev = _cuda()
    c, s, args = _storm(dev, "preempt", seed, big=seed == 9)
    kw = dict(use_gang=True, use_drf=use_drf, use_conformance=True, order_by_priority=True,
              gang_pipelined=gang_pipelined)
    VK.reset_launches()
    out_k = VK.preempt_solve(c, s, *args, **kw)
    assert VK.LAUNCHES["preempt_solve"] == 1
    _assert_victims_same(out_k, VK.preempt_solve_plain(c, s, *args, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("use_drf,chunks", [
    (False, dict(m_chunk=4, p_chunk=3, k_chunk=2)), (True, dict()),
])
def test_gpu_preempt_rounds_match_plain(seed, use_drf, chunks):
    dev = _cuda()
    c, s, args = _storm(dev, "rounds", seed, n_new=4, big=seed == 2)
    kw = dict(use_gang=True, use_drf=use_drf, use_conformance=True, order_by_priority=True,
              **chunks)
    VK.reset_launches()
    out_k = VK.preempt_rounds(c, s, *args, **kw)
    assert VK.LAUNCHES["preempt_rounds"] == 1
    _assert_victims_same(out_k, VK.preempt_rounds_plain(c, s, *args, **kw))


def _contended_spec(seed, n_nodes=8, storm=(3, 3)):
    """Low-priority singleton gangs fill every node of queue qa (two a
    node) and qb (one a node); urgent gangs in qa storm it, and a qb gang
    of weight 3 reclaims."""
    rng = np.random.default_rng(seed)
    spec = {"priority_classes": [{"name": "urgent", "value": 10}, {"name": "low", "value": 1}],
            "queues": [{"name": "qa"}, {"name": "qb", "weight": 3}, {"name": "default"}],
            "nodes": [{"name": f"n{i:02d}", "allocatable": {"cpu": "6", "memory": "12Gi",
                                                            "pods": 20}}
                      for i in range(n_nodes)],
            "podgroups": [], "pods": []}
    k = 0
    for i in range(n_nodes):
        for q in ("qa", "qa", "qb"):
            spec["podgroups"].append({"name": f"run{k}", "min_member": 1, "queue": q,
                                      "priority_class_name": "low", "phase": "Running"})
            spec["pods"].append({"name": f"run{k}-0", "group": f"run{k}", "priority": 1,
                                 "resources": {"cpu": "2", "memory": "4Gi"},
                                 "node_name": f"n{i:02d}", "phase": "Running"})
            k += 1
    n_gangs, size = storm
    for g in range(n_gangs):
        spec["podgroups"].append({"name": f"hot{g}", "min_member": size, "queue": "qa",
                                  "priority_class_name": "urgent", "phase": "Inqueue"})
        spec["pods"] += [{"name": f"hot{g}-{t}", "group": f"hot{g}", "priority": 10,
                          "resources": {"cpu": str(int(rng.choice([1, 2]))), "memory": "2Gi"}}
                         for t in range(size)]
    spec["podgroups"].append({"name": "recl", "min_member": 1, "queue": "qb",
                              "phase": "Inqueue"})
    spec["pods"].append({"name": "recl-0", "group": "recl",
                         "resources": {"cpu": "2", "memory": "2Gi"}})
    return spec


@pytest.mark.gpu
@pytest.mark.parametrize("solve_mode,storm", [("exact", (3, 3)), ("auto", (24, 3))])
@pytest.mark.parametrize("seed", range(2))
def test_gpu_contended_scheduler_equals_cpu(solve_mode, storm, seed):
    """The full five-action conf on a contended store: the cuda backend's
    reclaim and preempt passes (K8, K9, and K10 above the storm threshold)
    evict and bind what the cpu backend's plain versions do."""
    _cuda()
    outs = []
    for backend in ("cuda", "cpu"):
        store = interop.store_from_spec(_contended_spec(seed, storm=storm))
        conf = full_conf(backend)
        conf.solve_mode = solve_mode
        sched = Scheduler(store, conf=conf)
        VK.reset_launches()
        sched.run_once()
        if backend == "cuda":
            assert VK.LAUNCHES["reclaim_solve"] == 1
            assert VK.LAUNCHES["preempt_rounds" if storm[0] * storm[1] > 64
                               else "preempt_solve"] >= 1
        outs.append((list(sched.cache.evict_log), dict(sched.cache.bind_log),
                     {g.meta.key: g.status.phase for g in store.list("PodGroup")}))
    assert outs[0] == outs[1]
    assert outs[0][0], "the store must contend"


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["reclaim", "preempt", "rounds"])
def test_gpu_scalar_resource_solves_match_plain(kind):
    """K8-K10 with a third, scalar resource (R = 3) and three predicate
    classes against their plain versions."""
    dev = _cuda()
    c, s, args = _storm(dev, kind, 0, n_new=4 if kind == "rounds" else 3, scalar=True, classes=3)
    if kind == "reclaim":
        kw = dict(use_gang=True, use_prop=True, use_conformance=True, order_by_priority=True,
                  has_proportion=True)
        out_k, out_p = VK.reclaim_solve(c, s, *args, **kw), VK.reclaim_solve_plain(c, s, *args, **kw)
    elif kind == "preempt":
        kw = dict(use_gang=True, use_drf=True, use_conformance=True, order_by_priority=True)
        out_k, out_p = VK.preempt_solve(c, s, *args, **kw), VK.preempt_solve_plain(c, s, *args, **kw)
    else:
        kw = dict(use_gang=True, use_drf=True, use_conformance=True, order_by_priority=True,
                  m_chunk=4, p_chunk=3, k_chunk=2)
        out_k, out_p = (VK.preempt_rounds(c, s, *args, **kw),
                        VK.preempt_rounds_plain(c, s, *args, **kw))
    _assert_victims_same(out_k, out_p)


def _assert_step_same(out_k, out_p):
    assert torch.equal(out_k.packed.cpu(), out_p.packed.cpu())
    for f in VK.VictimState._fields:
        x, y = getattr(out_k.state, f).cpu(), getattr(out_p.state, f).cpu()
        if x.dtype.is_floating_point:
            assert torch.allclose(x, y, rtol=1e-6, atol=0.0), f
        else:
            assert torch.equal(x, y), f


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["queue", "job", "reclaim"])
@pytest.mark.parametrize("seed", range(3))
def test_gpu_victim_step_matches_plain(mode, seed):
    """K7 against its plain version over the veto and order flags, empty
    requests included, and its input state left untouched."""
    dev = _cuda()
    c_np, s_np = build_victim_sim(16, 120, 10, n_queues=3, seed=seed)
    c, s = interop.victim_from_arrays(c_np, s_np, dev)
    before = [x.clone() for x in s]
    groups = {obp: VK.victim_groups(c, s.run_live, order_by_priority=obp) for obp in (False, True)}
    rng = np.random.default_rng(seed)
    n_assigned = 0
    for flags in range(32):
        kw = dict(use_gang=bool(flags & 1), use_drf=bool(flags & 2), use_prop=bool(flags & 4),
                  use_conformance=bool(flags & 8), order_by_priority=bool(flags & 16))
        t_req = torch.tensor([float(rng.choice([0, 500, 1500, 3000])),
                              float(rng.choice([0, 512, 2048]) * (1 << 20))], device=dev)
        jt = int(rng.integers(0, 10))
        qt = int(c_np["job_queue"][jt])
        out_k = VK.victim_step(c, s, t_req, 0, jt, qt, mode=mode, **kw)
        out_p = VK.victim_step_plain(c, s, t_req, 0, jt, qt, mode=mode, **kw)
        _assert_step_same(out_k, out_p)
        # warm: the groups built once for these constants
        out_w = VK.victim_step(c, s, t_req, 0, jt, qt, mode=mode, groups=groups[bool(flags & 16)],
                               **kw)
        _assert_step_equal(out_w, out_p)
        n_assigned += int(out_p.packed[0])
    assert n_assigned
    for a, b in zip(before, s):
        assert torch.equal(a, b)


def _assert_step_equal(out_k, out_p):
    """The packed decision and every state field bit for bit."""
    assert torch.equal(out_k.packed.cpu(), out_p.packed.cpu())
    for f in VK.VictimState._fields:
        assert torch.equal(_rows(getattr(out_k.state, f)), _rows(getattr(out_p.state, f))), f


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(3))
def test_gpu_victim_groups_match_plain(seed):
    """The group build on the card equals its plain version: the live rows
    (and, at the small width, a mask of every row), both eviction orders,
    at small and at config-4 widths."""
    dev = _cuda()
    shapes = [(16, 120, 10)] + ([(10_000, 100_000, 5_000)] if seed == 0 else [])
    for n_nodes, n_victims, n_jobs in shapes:
        c_np, s_np = build_victim_sim(n_nodes, n_victims, n_jobs, n_queues=3, seed=seed)
        c, s = interop.victim_from_arrays(c_np, s_np, dev)
        masks = [s.run_live] + ([torch.ones_like(s.run_live)] if n_victims < 1000 else [])
        for live in masks:
            for obp in (False, True):
                g = VK.victim_groups(c, live, order_by_priority=obp)
                want = VK.victim_groups_plain(c, live, order_by_priority=obp)
                for x, y in zip(g[:5], want[:5]):
                    assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["queue", "job", "reclaim"])
def test_gpu_victim_step_chain_reuses_groups(mode):
    """32 solves over one grouping of the first state's live rows, each
    assignment's state fed to the next: every decision and state bit for
    bit the plain chain's, the input states untouched."""
    dev = _cuda()
    c_np, s_np = build_victim_sim(64, 400, 16, n_queues=3, seed=11)
    c, s = interop.victim_from_arrays(c_np, s_np, dev)
    # no proportion veto (build_victim_sim's deserved shares refuse every
    # victim), and the drf veto where it leaves victims to take
    kw = dict(use_gang=True, use_drf=mode == "queue", use_conformance=True)
    g = VK.victim_groups(c, s.run_live, order_by_priority=True)
    rng = np.random.default_rng(11)
    sk = sp = s
    n_ok = 0
    for _ in range(32):
        jt = int(rng.integers(0, 16))
        t_req = torch.tensor([float(rng.choice([250, 500, 1000, 2000])),
                              float(rng.choice([256, 512, 1024]) * (1 << 20))], device=dev)
        qt = int(c_np["job_queue"][jt])
        before = [x.clone() for x in sk]
        out_k = VK.victim_step(c, sk, t_req, 0, jt, qt, mode=mode, groups=g, **kw)
        out_p = VK.victim_step_plain(c, sp, t_req, 0, jt, qt, mode=mode, groups=g, **kw)
        _assert_step_equal(out_k, out_p)
        for a, b in zip(before, sk):
            assert torch.equal(a, b)
        if bool(out_p.packed[0]):
            sk, sp = out_k.state, out_p.state
            n_ok += int(out_p.packed[3] > 0)
    assert n_ok >= 3


@pytest.mark.gpu
@pytest.mark.parametrize("case,blocks,ev_kind", [
    (case, blocks, ev) for case in GROUP_EDGE_CASES for blocks in (1, 2, 4)
    for ev in ("preempt", "reclaim", "rounds")])
def test_gpu_group_build_edge_shapes(case, blocks, ev_kind):
    """The one group build (one cluster launch) against its plain version
    on the edge pools: empty nodes, a node of 1,500 rows, 65,536 node
    rows, out-of-range nodes, a live mask with holes; on each of 1, 2 and 4
    node blocks (rows of other blocks' nodes not grouped), every eviction
    kind, order_by_priority on and off; each build twice over one
    workspace, so no build depends on another's scratch."""
    from volcano_tpu_torch import _build

    dev = _cuda()
    c, s = interop.victim_from_arrays(*build_group_edge_args(case), dev)
    N = c.node_alloc.shape[0]
    nb = N // blocks
    lib, stream = _build.load(), K._stream(dev)
    for obp in (True, False):
        for b in range(blocks):
            want = VK.group_build_plain(c, s.run_live, obp, nb, ev_kind=ev_kind, n0=b * nb,
                                        nt=N)
            for _ in range(2):
                g = VK.victim_groups_launch(lib, stream, c, s.run_live, obp, nb,
                                            ev_kind=ev_kind, n0=b * nb, nt=N)
                for name, x, y in zip(VK.VictimGroups._fields, g[:5], want[:5]):
                    assert torch.equal(x, y), f"{name} obp={obp} block {b}"


@pytest.mark.gpu
def test_gpu_victim_groups_launches_and_mismatch():
    """Cold K7 launches the group build and the solve, warm the solve
    alone; groups of other constants, shapes, order or device raise."""
    dev = _cuda()
    c_np, s_np = build_victim_sim(16, 120, 10, seed=3)
    c, s = interop.victim_from_arrays(c_np, s_np, dev)
    t_req = torch.tensor([1000.0, float(1 << 30)], device=dev)
    VK.reset_launches()
    VK.victim_step(c, s, t_req, 0, 0, 0)
    assert (VK.LAUNCHES["victim_groups"], VK.LAUNCHES["victim_step"]) == (1, 1)
    g = VK.victim_groups(c, s.run_live)
    VK.victim_step(c, s, t_req, 0, 0, 0, groups=g)
    assert (VK.LAUNCHES["victim_groups"], VK.LAUNCHES["victim_step"]) == (2, 2)
    c2, _ = interop.victim_from_arrays(c_np, s_np, dev)
    with pytest.raises(ValueError, match="other constants"):
        VK.victim_step(c2, s, t_req, 0, 0, 0, groups=g)
    with pytest.raises(ValueError, match="order_by_priority"):
        VK.victim_step(c, s, t_req, 0, 0, 0, groups=g, order_by_priority=False)
    with pytest.raises(ValueError, match="groups of"):
        VK.victim_step(c, s, t_req, 0, 0, 0, groups=g._replace(node_off=g.node_off[:-1]))
    with pytest.raises(ValueError, match="int32 on"):
        VK.victim_step(c, s, t_req, 0, 0, 0, groups=g._replace(
            **{k: getattr(g, k).cpu() for k in ("node_off", "l_vidx", "l_ev", "l_drf",
                                                 "l_prop")}))
    with pytest.raises(ValueError, match="live"):
        VK.victim_groups(c, s.run_live.int())
    assert VK.LAUNCHES["victim_step"] == 2


@pytest.mark.gpu
def test_gpu_victim_step_launches_and_rejects_bad_input():
    dev = _cuda()
    c_np, s_np = build_victim_sim(8, 40, 6, seed=1)
    c, s = interop.victim_from_arrays(c_np, s_np, dev)
    VK.reset_launches()
    VK.victim_step(c, s, torch.tensor([1000.0, float(1 << 30)], device=dev), 0, 0, 0)
    assert VK.LAUNCHES["victim_step"] == 1
    with pytest.raises(ValueError):
        VK.victim_step(c, s, torch.tensor([1000.0, float(1 << 30)], device=dev), 0, 99, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(2))
def test_gpu_object_path_equals_cpu(seed):
    """fast_path off: the object path's preempt and reclaim drive K7 on the
    card and evict, pipeline and bind what the cpu backend does."""
    _cuda()
    outs = []
    for backend in ("cuda", "cpu"):
        store = interop.store_from_spec(_contended_spec(seed))
        conf = full_conf(backend)
        conf.fast_path = "off"
        sched = Scheduler(store, conf=conf)
        VK.reset_launches()
        sched.run_once()
        if backend == "cuda":
            assert VK.LAUNCHES["victim_step"] >= 1
        outs.append((list(sched.cache.evict_log), dict(sched.cache.bind_log),
                     {g.meta.key: g.status.phase for g in store.list("PodGroup")}))
    assert outs[0] == outs[1]
    assert outs[0][0], "the store must contend"


# -- the lifted shape caps, and the node-sharded solve (K12a) -------------------

@pytest.mark.gpu
@pytest.mark.parametrize("seed,releasing,with_portsel,case", [
    (0, False, False, None), (0, False, True, None), (1, True, False, None),
    (1, True, True, None),
] + [(0, False, False, case) for case in BATCH_EDGE_CASES])
def test_gpu_batch_solve_over_node_tiles_matches_plain(seed, releasing, with_portsel, case,
                                                       monkeypatch):
    """K3 with tiles of 4 node rows (four tiles a solve): the tile top-Ks
    merge into the exact top-K, so the decisions equal the plain version.
    ``case``: one of simargs.build_batch_edge_args's shapes of the chunked
    select and the spread accept (more jobs than a select chunk, fewer
    active jobs than M, priority 0, winners in every queue, one long node
    segment, a dropped gang's rollback)."""
    dev = _cuda()
    monkeypatch.setattr(K, "BATCH_TILE", 4)
    if case is not None:
        a, opts = build_batch_edge_args(case, seed)
        a = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
        des = K.water_fill(*_water_fill_inputs(a))
        args = {k: (des if k == "queue_deserved" else a[k]) for k in K._SOLVE_ARGS}
        _assert_same(K.allocate_solve_batch(*args.values(), 1.0, 1.0, **opts),
                     K.allocate_solve_batch_plain(**args, w_least=1.0, w_balanced=1.0,
                                                  **opts))
        return
    a = _args(dev, seed, releasing)
    des = K.water_fill(*_water_fill_inputs(a))
    args = {k: (des if k == "queue_deserved" else a[k]) for k in K._SOLVE_ARGS}
    ext = {}
    if with_portsel:
        p = build_portsel_args(14, 64, seed=seed, n_jobs=16, w_podaff=1.0)
        ext["portsel"] = tuple(p[k] if k == "w_podaff" else torch.from_numpy(p[k]).to(dev)
                               for k in PORTSEL_KEYS)
    out_k = K.allocate_solve_batch(*args.values(), 1.0, 1.0, m_chunk=4, p_chunk=3, **ext)
    out_p = K.allocate_solve_batch_plain(**args, w_least=1.0, w_balanced=1.0, m_chunk=4,
                                         p_chunk=3, **ext)
    _assert_same(out_k, out_p)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(2))
def test_gpu_preempt_rounds_over_node_tiles_match_plain(seed, monkeypatch):
    """K10 with tiles of 4 node rows."""
    dev = _cuda()
    monkeypatch.setattr(VK, "ROUNDS_TILE", 4)
    c, s, args = _storm(dev, "rounds", seed, n_new=4, n_nodes=12)
    kw = dict(use_gang=True, use_drf=True, use_conformance=True, order_by_priority=True)
    _assert_victims_same(VK.preempt_rounds(c, s, *args, **kw),
                         VK.preempt_rounds_plain(c, s, *args, **kw))


@pytest.mark.gpu
def test_gpu_many_queues_match_plain():
    """K2 with 128 queues and K1 with 2,048 (queue, dim) cells: past the
    old per-queue shared-memory tables."""
    dev = _cuda()
    a = {k: torch.from_numpy(v).to(dev)
         for k, v in build_sim_args(12, 256, 128, n_queues=100, seed=4).items()}
    assert a["queue_alloc_init"].shape[0] == 128
    des = K.water_fill(*_water_fill_inputs(a))
    assert torch.equal(des, K.water_fill_plain(*_water_fill_inputs(a)))
    args = {k: (des if k == "queue_deserved" else a[k]) for k in K._SOLVE_ARGS}
    _assert_same(K.allocate_solve(*args.values(), 1.0, 1.0),
                 K.allocate_solve_plain(**args, w_least=1.0, w_balanced=1.0))
    w = {k: torch.from_numpy(v).to(dev)
         for k, v in build_sim_args(12, 1200, 600, n_queues=600, seed=5).items()}
    assert w["queue_request"].numel() > 1024
    assert torch.equal(K.water_fill(*_water_fill_inputs(w)),
                       K.water_fill_plain(*_water_fill_inputs(w)))


@pytest.mark.gpu
@pytest.mark.parametrize("n_blocks,seed,case", [
    (n, seed, None) for n in (1, 2, 4, 8) for seed in range(2)
] + [(n, 0, case) for n in (1, 2, 4) for case in BATCH_EDGE_CASES])
def test_gpu_sharded_cycle_local_mesh_matches_plain(n_blocks, seed, case, monkeypatch):
    """K12a on a local mesh: the sharded cycle on the card equals its plain
    version on the same blocks and the one-block K3, bit for bit; ``case``
    one of simargs.build_batch_edge_args's shapes."""
    from volcano_tpu_torch.parallel import sharded as S

    dev = _cuda()
    monkeypatch.setattr(K, "BATCH_TILE", 8)
    if case is None:
        args = build_sim_args(64, 256, 32, n_queues=2, seed=seed)
        if seed:
            add_releasing(args, seed)
        opts = dict(m_chunk=8, p_chunk=4)
    else:
        args, opts = build_batch_edge_args(case, seed)
    mesh = S.LocalMesh(n_blocks, dev)
    fn, dargs = S.make_sharded_cycle(mesh, args, **opts)
    S.reset_launches()
    out_k = fn(dargs)
    assert S.LAUNCHES["sharded_cycle"] == 1
    cpu = S.LocalMesh(n_blocks, "cpu")
    pfn, pargs = S.make_sharded_cycle(cpu, args, **opts)
    out_p = pfn(pargs)
    ref = S.run_cycle_reference(args, device=dev, **opts)
    for name, k, p, r in zip(S.OUTPUT_NAMES, S.fetch_outputs(out_k, mesh),
                             S.fetch_outputs(out_p, cpu), S.fetch_outputs(ref)):
        np.testing.assert_array_equal(k, p, err_msg=name)
        np.testing.assert_array_equal(k, r, err_msg=name)


@pytest.mark.gpu
def test_gpu_mesh_scheduler_binds_equal_cpu():
    """The cuda backend with mesh "4" binds what the cpu backend binds."""
    _cuda()
    states = []
    for backend in ("cuda", "cpu"):
        store = interop.store_from_spec(_spec(1, n_nodes=16))
        conf = full_conf(backend)
        conf.solve_mode = "batch"
        conf.mesh = "4"
        sched = Scheduler(store, conf=conf)
        sched.run_once()
        states.append({p.meta.key: p.node_name for p in store.list("Pod")})
    assert states[0] == states[1] and any(states[0].values())


# -- the victim solve on node blocks (K12b) and the multi-controller cycle (K13)

def _rows(x):
    return (torch.cat(x) if isinstance(x, tuple) else x).cpu()


def _assert_blocked_same(out_k, out_p):
    """Packed decision and every state field bit for bit (node planes
    compared as their blocks' rows)."""
    assert torch.equal(out_k.packed.cpu(), out_p.packed.cpu())
    for f in VK.VictimState._fields:
        assert torch.equal(_rows(getattr(out_k.state, f)), _rows(getattr(out_p.state, f))), f


@pytest.mark.gpu
@pytest.mark.parametrize("n_blocks", [2, 4, 8])
@pytest.mark.parametrize("mode", ["queue", "job", "reclaim"])
def test_gpu_victim_step_sharded_matches_plain(n_blocks, mode):
    """K12b on a local mesh against its plain version on the same blocks
    and against the one-block K7, over the veto and order flags and two
    seeds, empty requests included: bit for bit, state included."""
    from volcano_tpu_torch.parallel import sharded as S

    dev = _cuda()
    mesh = S.LocalMesh(n_blocks, dev)
    n_assigned = 0
    for seed in range(2):
        c_np, s_np = build_victim_sim(16, 120, 10, n_queues=3, seed=seed)
        c, s = interop.victim_from_arrays(c_np, s_np, dev)
        _, dc, ds = S.make_sharded_victim_step(mesh, c, s)
        rng = np.random.default_rng(seed)
        for flags in range(32):
            kw = dict(mode=mode, use_gang=bool(flags & 1), use_drf=bool(flags & 2),
                      use_prop=bool(flags & 4), use_conformance=bool(flags & 8),
                      order_by_priority=bool(flags & 16))
            t_req = torch.tensor([float(rng.choice([0, 500, 1500, 3000])),
                                  float(rng.choice([0, 512, 2048]) * (1 << 20))], device=dev)
            jt = int(rng.integers(0, 10))
            qt = int(c_np["job_queue"][jt])
            nb = 16 // n_blocks
            out_k = VK.victim_step_sharded(dc, ds, t_req, 0, jt, qt, mesh, **kw)
            out_p = S.victim_blocks_plain(dc, ds, t_req, 0, jt, qt, mesh, nb, **kw)
            _assert_blocked_same(out_k, out_p)
            _assert_blocked_same(out_k, VK.victim_step(c, s, t_req, 0, jt, qt, **kw))
            n_assigned += int(out_p.packed[0])
    assert n_assigned


@pytest.mark.gpu
@pytest.mark.parametrize("n_blocks", [2, 4, 8])
def test_gpu_victim_step_sharded_chain_launches(n_blocks):
    """A chain of 10 preemptors, each assignment's blocked state fed to the
    next: one launch a solve, and every decision and the final state equal the
    one-block K7 chain's bit for bit."""
    from volcano_tpu_torch.parallel import sharded as S

    dev = _cuda()
    c_np, s_np = build_victim_sim(64, 256, 16, n_queues=1, seed=5)
    c, s = interop.victim_from_arrays(c_np, s_np, dev)
    mesh = S.LocalMesh(n_blocks, dev)
    _, dc, ds = S.make_sharded_victim_step(mesh, c, s)
    rng = np.random.default_rng(5)
    kw = dict(mode="queue", use_gang=True, use_drf=True, use_conformance=True)
    VK.reset_launches()
    n_ok = 0
    for _ in range(10):
        jt = int(rng.integers(0, 16))
        t_req = torch.tensor([float(rng.choice([1000, 2000, 4000])),
                              float(rng.choice([1, 2, 4]) * (1 << 30))], device=dev)
        qt = int(c_np["job_queue"][jt])
        out_k = VK.victim_step_sharded(dc, ds, t_req, 0, jt, qt, mesh, **kw)
        out_1 = VK.victim_step(c, s, t_req, 0, jt, qt, **kw)
        _assert_blocked_same(out_k, out_1)
        if bool(out_1.packed[0]):
            # the solve returns its updated state whenever it assigns
            ds, s = out_k.state, out_1.state
            n_ok += 1
    assert VK.LAUNCHES["victim_step_sharded"] == 10 and n_ok >= 3


@pytest.mark.gpu
@pytest.mark.parametrize("n_blocks", [1, 2, 4, 8])
def test_gpu_victim_step_sharded_warm_equals_k7(n_blocks):
    """K12b over one grouping of the whole pool on 1, 2, 4 and 8 blocks, a
    chain of 12 solves with the blocked state fed back: each bit for bit
    the one-block K7 chain's over the same grouping, two launches a solve
    and no group build."""
    from volcano_tpu_torch.parallel import sharded as S

    dev = _cuda()
    c_np, s_np = build_victim_sim(64, 400, 16, n_queues=2, seed=7)
    c, s = interop.victim_from_arrays(c_np, s_np, dev)
    mesh = S.LocalMesh(n_blocks, dev)
    _, dc, ds = S.make_sharded_victim_step(mesh, c, s)
    for mode in ("queue", "reclaim"):
        kw = dict(mode=mode, use_gang=True, use_drf=mode == "queue", use_conformance=True)
        g = VK.victim_groups(c, s.run_live)
        gb = VK.victim_groups(dc, ds.run_live, mesh=mesh)
        for x, y in zip(g[:5], gb[:5]):
            assert torch.equal(x, y)
        rng = np.random.default_rng(n_blocks)
        sk, s1 = ds, s
        VK.reset_launches()
        for _ in range(12):
            jt = int(rng.integers(0, 16))
            t_req = torch.tensor([float(rng.choice([500, 1000, 2000])),
                                  float(rng.choice([1, 2]) * (1 << 30))], device=dev)
            qt = int(c_np["job_queue"][jt])
            out_k = VK.victim_step_sharded(dc, sk, t_req, 0, jt, qt, mesh, groups=gb, **kw)
            out_1 = VK.victim_step(c, s1, t_req, 0, jt, qt, groups=g, **kw)
            _assert_step_equal(out_k, out_1)
            if bool(out_1.packed[0]):
                sk, s1 = out_k.state, out_1.state
        assert VK.LAUNCHES["victim_step_sharded"] == 12
        assert VK.LAUNCHES["victim_groups"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", ["2", "4"])
def test_gpu_object_path_mesh_equals_cpu(mesh):
    """fast_path off, a mesh with solve_mode batch: the object path's
    preempt and reclaim drive K12b on the card and evict, pipeline and bind
    what the cpu backend does."""
    _cuda()
    outs = []
    for backend in ("cuda", "cpu"):
        store = interop.store_from_spec(_contended_spec(0))
        conf = full_conf(backend)
        conf.fast_path, conf.solve_mode, conf.mesh = "off", "batch", mesh
        sched = Scheduler(store, conf=conf)
        VK.reset_launches()
        sched.run_once()
        if backend == "cuda":
            assert VK.LAUNCHES["victim_step_sharded"] >= 1
            assert VK.LAUNCHES["victim_step"] == 0
        outs.append((list(sched.cache.evict_log), dict(sched.cache.bind_log),
                     {g.meta.key: g.status.phase for g in store.list("PodGroup")}))
    assert outs[0] == outs[1]
    assert outs[0][0], "the store must contend"


@pytest.mark.gpu
@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_gpu_run_lockstep_matches_cpu(n_hosts, monkeypatch):
    """K13 on the card: the lockstep cycle over four node blocks equals the
    same cycle's plain version on the CPU bit for bit, all 11 outputs."""
    from volcano_tpu_torch.parallel import multihost as MH

    dev = _cuda()
    monkeypatch.setattr(K, "BATCH_TILE", 8)
    args = build_sim_args(64, 256, 32, n_queues=2, seed=n_hosts)
    got = MH.run_lockstep(args, n_hosts, n_blocks=4, m_chunk=8, p_chunk=4, device=dev)
    want = MH.run_lockstep(args, n_hosts, n_blocks=4, m_chunk=8, p_chunk=4, device="cpu")
    for name, k, p in zip(MH.OUTPUT_NAMES, got["outputs"], want["outputs"]):
        np.testing.assert_array_equal(k, p, err_msg=name)
    assert (got["outputs"][1] > 0).sum() > 0


def _blocked_flat(out):
    """A storm solve's outputs by name, node planes joined."""
    flat = {}
    for f in out._fields:
        part = getattr(out, f)
        items = ({f"{f}.{g}": getattr(part, g) for g in part._fields}
                 if hasattr(part, "_fields") else {f: part})
        for k, x in items.items():
            flat[k] = _rows(x) if isinstance(x, tuple) else torch.as_tensor(x).cpu()
    return flat


def _assert_storm_blocked_same(out_k, out_p):
    fk, fp = _blocked_flat(out_k), _blocked_flat(out_p)
    assert fk.keys() == fp.keys()
    for name, x in fk.items():
        assert torch.equal(x, fp[name].to(x.dtype)), name


#: K15a-c cases: (kind, seed, sim keywords, solve flags)
K15_CASES = [
    ("reclaim", 0, {}, dict(use_gang=True, use_prop=True, use_conformance=True,
                            order_by_priority=True, has_proportion=True)),
    ("reclaim", 2, {}, dict(use_gang=False, use_prop=False, use_conformance=True,
                            order_by_priority=True, has_proportion=False)),
    ("preempt", 0, {}, dict(use_gang=True, use_drf=True, use_conformance=True,
                            order_by_priority=True)),
    ("preempt", 9, dict(big=True), dict(use_gang=False, use_drf=True, use_conformance=True,
                                        order_by_priority=True, gang_pipelined=False)),
    ("rounds", 0, dict(n_new=4), dict(use_gang=True, use_drf=False, use_conformance=True,
                                      order_by_priority=True, m_chunk=4, p_chunk=3,
                                      k_chunk=2)),
    ("rounds", 1, dict(n_new=4), dict(use_gang=True, use_drf=True, use_conformance=True,
                                      order_by_priority=False, m_chunk=8, p_chunk=2,
                                      k_chunk=4)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("n_blocks", [1, 2, 4, 8])
@pytest.mark.parametrize("case", range(len(K15_CASES)))
def test_gpu_contention_solves_on_blocks_match_plain(case, n_blocks):
    """K15a-c on a local mesh against their plain versions on the same
    blocks and against the one-block K8 / K9 / K10 (rollbacks and aborts
    among the preempt cases): bit for bit, state included; each wrapper
    counts its launch."""
    from volcano_tpu_torch.parallel import sharded as S

    dev = _cuda()
    kind, seed, sim, kw = K15_CASES[case]
    c, s, args = _storm(dev, kind, seed, **sim)
    mesh = S.LocalMesh(n_blocks, dev)
    dc, ds = S._place_victim(mesh, c), S._place_victim(mesh, s)
    nb = c.node_alloc.shape[0] // n_blocks
    name = {"reclaim": "reclaim_solve", "preempt": "preempt_solve",
            "rounds": "preempt_rounds"}[kind]
    plain = {"reclaim": S.reclaim_blocks_plain, "preempt": S.preempt_blocks_plain,
             "rounds": S.rounds_blocks_plain}[kind]
    VK.reset_launches()
    out_k = getattr(VK, name + "_sharded")(dc, ds, *args, mesh, **kw)
    assert VK.LAUNCHES[name + "_sharded"] == 1 and VK.LAUNCHES[name] == 0
    _assert_storm_blocked_same(out_k, plain(dc, ds, *args, mesh, nb, **kw))
    _assert_storm_blocked_same(out_k, getattr(VK, name)(c, s, *args, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("n_blocks", [1, 4])
@pytest.mark.parametrize("case", ROUNDS_EDGE_CASES)
def test_gpu_rounds_edge_matches_plain(case, n_blocks):
    """K10 (one block) and K15c (a local mesh of four) on each edge shape of
    the within-job count and the job select (``build_rounds_edge_args``):
    bit for bit their plain versions, state included; on four blocks also
    the one-block K10; each wrapper counts its launch."""
    from volcano_tpu_torch.parallel import sharded as S

    dev = _cuda()
    c, s, t, kw = build_rounds_edge_args(case)
    tc, ts = interop.victim_from_arrays(c, s, dev)
    args = [torch.from_numpy(np.asarray(a)).to(dev) for a in storm_inputs("rounds", c, s, t)]
    VK.reset_launches()
    if n_blocks == 1:
        out_k = VK.preempt_rounds(tc, ts, *args, **kw)
        assert VK.LAUNCHES["preempt_rounds"] == 1
        _assert_victims_same(out_k, VK.preempt_rounds_plain(tc, ts, *args, **kw))
        assert int(out_k.att_total) > 0
        return
    mesh = S.LocalMesh(n_blocks, dev)
    dc, ds = S._place_victim(mesh, tc), S._place_victim(mesh, ts)
    out_k = VK.preempt_rounds_sharded(dc, ds, *args, mesh, **kw)
    assert VK.LAUNCHES["preempt_rounds_sharded"] == 1 and VK.LAUNCHES["preempt_rounds"] == 0
    nb = tc.node_alloc.shape[0] // n_blocks
    _assert_storm_blocked_same(out_k, S.rounds_blocks_plain(dc, ds, *args, mesh, nb, **kw))
    _assert_storm_blocked_same(out_k, VK.preempt_rounds(tc, ts, *args, **kw))


# -- K8 / K9 on a thread-block cluster, K15a / K15b on node blocks -----------

def _walk_inputs(dev, case, kind):
    c, s, t, kw = build_walk_edge_args(case, kind)
    tc, ts = interop.victim_from_arrays(c, s, dev)
    args = [a if isinstance(a, int) else torch.from_numpy(np.asarray(a)).to(dev)
            for a in storm_inputs(kind, c, s, t)]
    return tc, ts, args, kw


def _walk_launch(kind, dev, *args, **kw):
    from volcano_tpu_torch import _build

    launch = VK.reclaim_launch if kind == "reclaim" else VK.preempt_launch
    return launch(_build.load(), K._stream(dev), *args, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["reclaim", "preempt"])
@pytest.mark.parametrize("case", WALK_EDGE_CASES)
def test_gpu_walk_edge_matches_plain(case, kind):
    """K8 / K9 on each edge shape of ``build_walk_edge_args`` at every
    cluster size the card admits (the portable 1, 2, 4, 8 must be) and at
    the default, and K15a / K15b on local meshes of 1, 2 and 4 blocks: bit
    for bit the plain version, state included; each wrapper counts its
    launch."""
    from volcano_tpu_torch.parallel import sharded as S

    dev = _cuda()
    c, s, args, kw = _walk_inputs(dev, case, kind)
    name = "reclaim_solve" if kind == "reclaim" else "preempt_solve"
    want = getattr(VK, name + "_plain")(c, s, *args, **kw)
    admitted = []
    for cl in VK.WALK_CLUSTERS + (None,):
        try:
            out = _walk_launch(kind, dev, c, s, *args, cluster=cl, **kw)
            torch.cuda.synchronize()
        except RuntimeError:
            assert cl == 16, f"portable cluster size {cl} refused"
            continue
        _assert_victims_same(out, want)
        admitted.append(cl)
    assert {1, 2, 4, 8, None} <= set(admitted)
    VK.reset_launches()
    _assert_victims_same(getattr(VK, name)(c, s, *args, **kw), want)
    assert VK.LAUNCHES[name] == 1
    for n_blocks in (1, 2, 4):
        mesh = S.LocalMesh(n_blocks, dev)
        dc, ds = S._place_victim(mesh, c), S._place_victim(mesh, s)
        VK.reset_launches()
        out = getattr(VK, name + "_sharded")(dc, ds, *args, mesh, **kw)
        assert VK.LAUNCHES[name + "_sharded"] == 1 and VK.LAUNCHES[name] == 0
        _assert_storm_blocked_same(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["reclaim", "preempt"])
def test_gpu_walk_timed_cluster_choice_and_refusals(kind):
    """The timed walk gives the untimed outputs, fills its split (the
    stages, the attempts) and ran on the largest admitted cluster; a size
    outside WALK_CLUSTERS raises."""
    dev = _cuda()
    c, s, args, kw = _walk_inputs(dev, "row_counts", kind)
    out = _walk_launch(kind, dev, c, s, *args, **kw)
    split = torch.zeros(32, dtype=torch.int64, device=dev)
    timed = _walk_launch(kind, dev, c, s, *args, split=split, **kw)
    torch.cuda.synchronize()
    _assert_victims_same(timed, out)
    sp = split.cpu().tolist()
    assert sp[0] > 0 and sp[1] > 0 and sp[8] >= int(out.rec.att) > 0
    assert sp[12] in (8, 16) and sp[13] == 1024  # the largest admitted size; 8 is portable
    with pytest.raises(ValueError, match="cluster"):
        _walk_launch(kind, dev, c, s, *args, cluster=3, **kw)


# -- K2 on a thread-block cluster --------------------------------------------

def _exact_inputs(dev, a, ps=None, vs=None):
    """The exact solve's named inputs on ``dev`` (K1's deserved shares) and
    its portsel / volsel keywords."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in a.items()}
    des = K.water_fill(*_water_fill_inputs(t))
    si = {k: (des if k == "queue_deserved" else t[k]) for k in K._SOLVE_ARGS}
    ext = {}
    if ps is not None:
        ext["portsel"] = tuple(ps[k] if k == "w_podaff" else torch.from_numpy(ps[k]).to(dev)
                               for k in PORTSEL_KEYS)
    if vs is not None:
        ext["volsel"] = interop.volsel_from_payload(vs, dev)
    return si, ext


def _exact_launch(si, opts, cluster=None, split=None, **ext):
    from volcano_tpu_torch import _build

    pol = dict(dict(job_key_order=("priority", "gang", "drf"), use_gang_ready=True,
                    use_proportion=True), **opts)
    return K.solve_launch(_build.load(), K._stream(si["idle"].device), False, si, 1.0, 1.0,
                          pol["job_key_order"], pol["use_gang_ready"], pol["use_proportion"],
                          cluster=cluster, split=split, **ext)


def _assert_exact_same(out_k, out_p):
    _assert_same(out_k, out_p)
    if hasattr(out_p, "claim_node"):
        assert torch.equal(out_k.claim_node, out_p.claim_node)
        assert torch.equal(out_k.vol_cap, out_p.vol_cap)


def _exact_at_every_cluster(si, opts, ext):
    """The kernel at each cluster size against the plain version; the
    portable sizes (1, 2, 4, 8) must be admitted, and a size the card
    refuses raises.  Returns the sizes admitted."""
    pol = dict(dict(job_key_order=("priority", "gang", "drf"), use_gang_ready=True,
                    use_proportion=True), **opts)
    out_p = K.allocate_solve_plain(**si, w_least=1.0, w_balanced=1.0, **pol, **ext)
    admitted = []
    for c in K.EXACT_CLUSTERS:
        try:
            out_k = _exact_launch(si, opts, cluster=c, **ext)
            torch.cuda.synchronize()
        except RuntimeError:
            assert c == 16, f"portable cluster size {c} refused"
            continue
        _assert_exact_same(out_k, out_p)
        admitted.append(c)
    return admitted, out_p


@pytest.mark.gpu
@pytest.mark.parametrize("case", EXACT_EDGE_CASES)
def test_gpu_exact_edge_shapes_match_plain(case):
    """K2 (with K5 / K6 where the case carries them) on every edge shape
    of simargs.build_exact_edge_args at each cluster size the card admits,
    bit for bit its plain version, volume state included."""
    dev = _cuda()
    a, opts, ps, vs = build_exact_edge_args(case)
    si, ext = _exact_inputs(dev, a, ps, vs)
    admitted, out_p = _exact_at_every_cluster(si, opts, ext)
    assert {1, 2, 4, 8} <= set(admitted)
    assert int(out_p.steps) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("ext_kind", ["plain", "portsel+volsel"])
def test_gpu_exact_past_the_resident_budget_matches_plain(ext_kind):
    """131,072 node rows (100,000 valid) and 400 tasks: a CTA's slice is
    larger than its shared memory at every cluster size, so part of it runs
    from the working copies in global memory, in the same kernel."""
    dev = _cuda()
    a = build_sim_args(100_000, 400, 40, n_queues=3, seed=11, n_classes=3, class_fill=0.7)
    add_releasing(a, 11)
    ps = vs = None
    if ext_kind != "plain":
        ps = build_portsel_args(100_000, 400, seed=11, n_jobs=40)
        vs = build_volsel_args(100_000, 400, seed=11, n_jobs=40)
    assert a["idle"].shape[0] == 131_072
    si, ext = _exact_inputs(dev, a, ps, vs)
    admitted, out_p = _exact_at_every_cluster(si, {}, ext)
    assert {1, 2, 4, 8} <= set(admitted) and int(out_p.steps) > 0


@pytest.mark.gpu
def test_gpu_exact_cluster_choice_launches_and_refusals():
    """allocate_solve is one launch; the timed instantiation gives the same
    outputs, fills its split and ran on the largest admitted cluster; a
    size outside EXACT_CLUSTERS and options the batch solve lacks raise."""
    dev = _cuda()
    a = build_sim_args(14, 64, 16, n_queues=3, seed=2, n_classes=3, class_fill=0.6)
    si, _ = _exact_inputs(dev, a)
    K.reset_launches()
    out = K.allocate_solve(*si.values(), 1.0, 1.0)
    torch.cuda.synchronize()
    assert K.LAUNCHES["allocate_solve"] == 1
    split = torch.zeros(32, dtype=torch.int64, device=dev)
    timed = _exact_launch(si, {}, split=split)
    torch.cuda.synchronize()
    _assert_same(timed, out)
    sp = split.cpu().tolist()
    assert sp[0] > 0 and sp[8] == int(out.steps) + int(out.dropped.sum()) and sp[9] > 0
    assert sp[12] in (8, 16)  # the largest admitted size; 8 is portable
    with pytest.raises(ValueError, match="cluster"):
        _exact_launch(si, {}, cluster=3)
    with pytest.raises(TypeError, match="cluster"):
        from volcano_tpu_torch import _build

        K.solve_launch(_build.load(), K._stream(dev), True, si, 1.0, 1.0,
                       ("priority", "gang", "drf"), True, True, cluster=8)

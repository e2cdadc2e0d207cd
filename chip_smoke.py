#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (volcano_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --profile [OUT.json]  # first a profiler pass

Phases, each fatal on failure:

1. build — compile csrc/*.cu with nvcc (one process per source) and print
   the card's name and power limit and ptxas's register/shared-memory
   report;
2. kernels — each kernel on the card at main-path shapes against its plain
   PyTorch version on the same card and inputs, with CUDA-event times:
   water_fill and allocate_solve_batch at build_sim_args(10000, 100000,
   5000), with the packed decision buffer the solve writes and its one
   fetch to the host; allocate_solve at
   build_sim_args(10000, 4000, 200); then a sweep of small solves over
   seeds and policies (classes, pod caps, releasing capacity, rollbacks);
3. e2e batch — the port's Scheduler(store, full_conf("cuda") with actions
   enqueue, allocate, backfill).run_once() on the config-5 store (10,000
   nodes, 5,000 gangs x 20 tasks, 2,000 best-effort pods), launch counts
   reset just before and read just after;
4. e2e exact — the same nodes with 200 gangs x 20 tasks (the exact solve).

With ``--profile``, a torch.profiler pass over one config-5 batch solve
and one config-5 cycle runs after the build: device time by kernel and the
device's idle share of the cycle (also written to OUT.json when given).

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero with no result line
when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_OPS_PER_S = 67e12         # H100 SXM fp32, outside the tensor cores
D2H_BYTES_PER_S = 64e9         # PCIe Gen5 x16, one direction

# operations per (job, node) pair of the batch solve's score pass, and per
# node of the exact solve's place step, as the function needs them (R = 2):
# idle and releasing fits 8, class and pod-cap predicates 2, used_after 2,
# free 4, least 6, shares 2, balanced 3, weighted sum 3, then (batch only)
# the jitter hash and its fused add 8, the mask 1, and top-K/argmax 1
BATCH_PAIR_OPS = 40
EXACT_NODE_OPS = 31
# per valid job of an exact select step: the active mask and the lex narrowing
EXACT_JOB_OPS = 10

# config 5 (bench.py: N_NODES, N_TASKS, N_JOBS, N_QUEUES, n_best_effort)
CFG5 = dict(nodes=10_000, jobs=5_000, tasks_per_job=20, queues=2, best_effort=2_000)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*arrays):
    return int(sum(a.numel() * a.element_size() for a in arrays))


def phase_build():
    from volcano_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=True,
    ).stdout.strip()
    t0 = time.perf_counter()
    _build.load()
    log(f"[build] nvcc build+load {time.perf_counter() - t0:.2f} s")
    for line in _build.ptxas_report():
        log(f"[ptxas] {line}")
    return smi


def _water_fill_rounds(a):
    """Round count of the water fill on these inputs (for its op count)."""
    w, req, rem = a["queue_weight"], a["queue_request"], a["total"].copy()
    eps, part = a["eps"], a["queue_participates"]
    des = np.zeros_like(req)
    met = np.zeros(w.shape[0], bool)
    rounds = 0
    while True:
        rounds += 1
        live = part & ~met
        tw = np.float32(w[live].sum())
        frac = np.where(tw > 0, w / max(tw, np.float32(1e-30)), 0).astype(np.float32)
        nd = des + np.where(live[:, None], rem[None, :] * frac[:, None], 0)
        exc = ~(nd < req + eps).all(1) & live
        cap = np.where(exc[:, None], np.minimum(nd, req), nd)
        met |= exc
        rem = rem - (cap - des).sum(0)
        des = cap
        if not (tw > 0 and not (rem < eps).all()):
            return rounds


def _batch_solve_ops(out, a, M, P, n_sort_keys):
    """Operations the batched solve's data needs, round by round: scoring
    the heads of the selected active jobs over the valid nodes, ordering
    the active jobs (a log2 a comparisons of n_sort_keys keys) and ordering
    their proposals (f log2 f comparisons of a node and a rank).  The
    active count of round r is the number of jobs whose surviving
    placements reach round r or later, a lower bound of the true count."""
    F = M * P
    seq = out.task_seq.cpu().numpy()
    job = a["task_job"].cpu().numpy()
    placed = seq >= 0
    last = np.full(a["job_queue"].shape[0], -1, np.int64)
    np.maximum.at(last, job[placed], seq[placed] // F)
    n_valid = int(a["node_valid"].sum())
    ops = 0.0
    for r in range(int(out.steps)):
        act = int((last >= r).sum())
        sel = min(M, act)
        f = sel * P
        ops += sel * n_valid * BATCH_PAIR_OPS
        ops += act * np.log2(max(act, 1)) * n_sort_keys + f * np.log2(max(f, 1)) * 2
    return ops


def _exact_solve_ops(out, a):
    """Operations the exact solve's data needs: one place step over the
    valid nodes per placement and per drop, and one select step over the
    valid jobs for each job that placed and each drop (a lower bound: a
    job ready before its last task is selected again for each one)."""
    n_valid = int(a["node_valid"].sum())
    j_valid = int((a["job_queue"] >= 0).sum())
    steps, drops = int(out.steps), int(out.dropped.sum())
    jobs_placed = int(np.unique(a["task_job"][out.task_kind > 0].cpu().numpy()).size)
    return (steps + drops) * n_valid * EXACT_NODE_OPS + (jobs_placed + drops) * j_valid * EXACT_JOB_OPS


def phase_kernels():
    import torch

    from volcano_tpu_torch.scheduler import kernels as K
    from volcano_tpu_torch.scheduler.simargs import build_sim_args

    dev = torch.device("cuda")
    rows = []

    def to_dev(a):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in a.items()}

    # ---- K1 water_fill + K3 batch + K4 packed at config-5 shapes
    a_np = build_sim_args(10_000, 100_000, 5_000)
    a = to_dev(a_np)
    wf = (a["queue_weight"], a["queue_request"], a["total"], a["eps"], a["queue_participates"])
    K.reset_launches()
    des_k = K.water_fill(*wf)
    des_p = K.water_fill_plain(*wf)
    torch.cuda.synchronize()
    err = float((des_k - des_p).abs().max())
    if not torch.equal(des_k, des_p):
        raise AssertionError(f"water_fill: kernel != plain (max abs err {err})")
    ms = cuda_ms(lambda: K.water_fill(*wf), 50)
    plain_ms = cuda_ms(lambda: K.water_fill_plain(*wf), 5)
    Q, R = a["queue_request"].shape
    rounds = _water_fill_rounds(a_np)
    b, kind = bound_ms(nbytes(*wf) + Q * R * 4, rounds * Q * R * 12)
    rows.append(dict(name="water_fill", route="cuda",
                     source="volcano_tpu_torch/csrc/water_fill.cu",
                     replaces="volcano_tpu/scheduler/kernels.py:73",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                     bound_by=kind, library_ms=None))
    log(f"[kernels] water_fill ok: {ms:.4f} ms (plain {plain_ms:.3f} ms), rounds {rounds}")

    solve_in = {k: (des_k if k == "queue_deserved" else a[k]) for k in K._SOLVE_ARGS}
    opts = dict(job_key_order=("priority", "gang", "drf"), use_gang_ready=True,
                use_proportion=True)
    args = [solve_in[k] for k in K._SOLVE_ARGS] + [1.0, 1.0]

    t0 = time.perf_counter()
    out_k = K.allocate_solve_batch(*args, **opts)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_p = K.allocate_solve_batch_plain(**solve_in, w_least=1.0, w_balanced=1.0, **opts)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    err = _compare("allocate_solve_batch", out_k, out_p)
    n_rounds = int(out_k.steps)
    placed = int((out_k.task_kind > 0).sum())
    log(f"[kernels] allocate_solve_batch ok: rounds {n_rounds}, placed {placed}, "
        f"first call {t_k:.3f} s, plain {t_p:.3f} s")
    ms = cuda_ms(lambda: K.allocate_solve_batch(*args, **opts), 3)
    plain_ms = cuda_ms(lambda: K.allocate_solve_batch_plain(
        **solve_in, w_least=1.0, w_balanced=1.0, **opts), 1)
    J = a["job_queue"].shape[0]
    M, P = min(512, J), 16
    io = nbytes(*solve_in.values()) + nbytes(*out_k[:10])
    n_sort_keys = len(opts["job_key_order"]) + 2 + int(opts["use_proportion"])
    b, kind = bound_ms(io, _batch_solve_ops(out_k, a, M, P, n_sort_keys))
    rows.append(dict(name="allocate_solve_batch", route="cuda",
                     source="volcano_tpu_torch/csrc/allocate_batch.cu",
                     replaces="volcano_tpu/scheduler/kernels.py:491",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                     bound_by=kind, library_ms=None))
    log(f"[kernels] allocate_solve_batch: {ms:.3f} ms (plain {plain_ms:.3f} ms, "
        f"bound {b:.4f} ms by {kind})")

    # K4 is no launch of its own: the solves write their decisions straight
    # into one int32 [3T + J] buffer, which the cycle fetches once
    packed = K.pack_outputs(out_k)
    if packed.data_ptr() != out_k.task_node.data_ptr():
        raise AssertionError("packed layout: the solve's decisions are not one buffer")
    if not torch.equal(packed, K.pack_outputs(out_p)):
        raise AssertionError("packed layout: kernel buffer != packed plain outputs")
    fetch_ms = cuda_ms(lambda: packed.cpu(), 20)
    cat_fetch_ms = cuda_ms(lambda: K.pack_outputs(out_p).cpu(), 20)
    log(f"[fetch] packed decisions ok: {nbytes(packed)} bytes to the host in "
        f"{fetch_ms:.4f} ms (the plain outputs' cat + fetch {cat_fetch_ms:.4f} ms; "
        f"bound {nbytes(packed) / D2H_BYTES_PER_S * 1e3:.4f} ms at PCIe Gen5 x16)")

    # ---- K2 exact at the exact path's shapes
    e_np = build_sim_args(10_000, 4_000, 200)
    e = to_dev(e_np)
    des_e = K.water_fill(e["queue_weight"], e["queue_request"], e["total"], e["eps"],
                         e["queue_participates"])
    solve_e = {k: (des_e if k == "queue_deserved" else e[k]) for k in K._SOLVE_ARGS}
    args_e = [solve_e[k] for k in K._SOLVE_ARGS] + [1.0, 1.0]
    out_k = K.allocate_solve(*args_e, **opts)
    t0 = time.perf_counter()
    out_p = K.allocate_solve_plain(**solve_e, w_least=1.0, w_balanced=1.0, **opts)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    err = _compare("allocate_solve", out_k, out_p)
    steps = int(out_k.steps)
    ms = cuda_ms(lambda: K.allocate_solve(*args_e, **opts), 3)
    io = nbytes(*solve_e.values()) + nbytes(*out_k[:10])
    b, kind = bound_ms(io, _exact_solve_ops(out_k, e))
    rows.append(dict(name="allocate_solve", route="cuda",
                     source="volcano_tpu_torch/csrc/allocate_solve.cu",
                     replaces="volcano_tpu/scheduler/kernels.py:185",
                     max_abs_err=err, ms=ms, plain_ms=t_p * 1e3, bound_ms=b,
                     bound_by=kind, library_ms=None))
    log(f"[kernels] allocate_solve ok: steps {steps}, {ms:.3f} ms (plain {t_p * 1e3:.1f} ms, "
        f"bound {b:.4f} ms by {kind})")
    return {r["name"]: r for r in rows}


def phase_kernel_sweep():
    """Each solve kernel against its plain version on the card at small
    shapes over seeds and policies: predicate classes, pod caps, releasing
    capacity (pipelined placements), gang rollbacks, small batch chunks."""
    import torch

    from volcano_tpu_torch.scheduler import kernels as K
    from volcano_tpu_torch.scheduler.simargs import add_releasing, build_sim_args

    dev = torch.device("cuda")
    policies = [
        dict(job_key_order=("priority", "gang", "drf"), use_gang_ready=True, use_proportion=True),
        dict(job_key_order=("drf", "gang", "priority"), use_gang_ready=False, use_proportion=False),
        dict(job_key_order=("gang", "priority", "drf"), use_gang_ready=True, use_proportion=False),
    ]
    n = pipelined = 0
    for seed in range(4):
        for pol in policies:
            a = build_sim_args(12 + seed, 64, 16, n_queues=3, seed=seed,
                               n_classes=1 + 2 * (seed % 2), class_fill=0.6 + 0.1 * seed)
            if seed:
                add_releasing(a, seed)
            a["node_max_tasks"][:] = 3 + seed
            t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in a.items()}
            des = K.water_fill(t["queue_weight"], t["queue_request"], t["total"], t["eps"],
                               t["queue_participates"])
            args = {k: (des if k == "queue_deserved" else t[k]) for k in K._SOLVE_ARGS}
            for batch, chunks in ((False, {}), (True, {}), (True, dict(m_chunk=4, p_chunk=3))):
                wrap = K.allocate_solve_batch if batch else K.allocate_solve
                plain = K.allocate_solve_batch_plain if batch else K.allocate_solve_plain
                out_k = wrap(*args.values(), 1.0, 1.0, **pol, **chunks)
                out_p = plain(**args, w_least=1.0, w_balanced=1.0, **pol, **chunks)
                _compare(f"sweep seed={seed} batch={batch} {chunks} {pol}", out_k, out_p)
                pipelined += int((out_p.task_kind == 2).sum())
                n += 1
    if not pipelined:
        raise AssertionError("kernel sweep: no pipelined placement exercised")
    log(f"[kernels] sweep ok: {n} small solves equal to their plain versions "
        f"({pipelined} pipelined placements)")


def _compare(name, out_k, out_p):
    """Decision outputs must be equal; float state equal too (exact sums)."""
    import torch

    err = 0.0
    for field in out_k._fields:
        x, y = getattr(out_k, field), getattr(out_p, field)
        if field in ("task_node", "task_kind", "task_seq", "ready", "dropped", "steps"):
            if not torch.equal(x.to(y.dtype), y):
                diff = (x.to(y.dtype) != y).nonzero()[:5].flatten().tolist()
                raise AssertionError(f"{name}: {field} differs at {diff}")
        else:
            err = max(err, float((x - y).abs().max()))
            if not torch.allclose(x, y, rtol=1e-6, atol=0.0):
                raise AssertionError(f"{name}: {field} differs (max abs err {err})")
    return err


def build_cfg5_store(n_jobs=CFG5["jobs"], n_best_effort=CFG5["best_effort"]):
    """bench.py _build_e2e_store (dynamic_frac=0, volume_tasks=0) with the
    port's objects: 10k nodes, n_jobs gangs x 20 tasks in 2 weighted queues
    (plus "default"), PodGroups Pending (enqueue admits them), and one
    best-effort pod on each of the first n_best_effort gangs."""
    from volcano_tpu_torch.api import (
        POD_GROUP_KEY, Metadata, Node, Pod, PodGroup, PodGroupPhase, PodSpec,
        Queue, Resource,
    )
    from volcano_tpu_torch.store import Store

    rng = np.random.default_rng(0)
    n_nodes, tpj, n_q = CFG5["nodes"], CFG5["tasks_per_job"], CFG5["queues"]
    node_cpu = rng.choice([8000, 16000, 32000], n_nodes)
    node_mem = rng.choice([16, 32, 64], n_nodes) * (1 << 30)
    cpus = rng.choice([250, 500, 1000, 2000], CFG5["jobs"] * tpj)
    mems = rng.choice([256, 512, 1024, 2048], CFG5["jobs"] * tpj) * (1 << 20)
    store = Store()
    for q in range(n_q):
        store.create("Queue", Queue(meta=Metadata(name=f"q{q}", namespace=""), weight=n_q - q))
    store.create("Queue", Queue(meta=Metadata(name="default", namespace=""), weight=1))
    for i in range(n_nodes):
        store.create("Node", Node(meta=Metadata(name=f"n{i:05d}", namespace=""),
                                  allocatable=Resource(float(node_cpu[i]), float(node_mem[i]),
                                                       max_task_num=110)))
    k = 0
    for j in range(n_jobs):
        pg = PodGroup(meta=Metadata(name=f"pg{j:05d}", namespace="default"),
                      min_member=tpj, queue=f"q{j % n_q}")
        pg.status.phase = PodGroupPhase.PENDING
        store.create("PodGroup", pg)
        ann = {POD_GROUP_KEY: f"pg{j:05d}"}
        for t in range(tpj):
            store.create("Pod", Pod(
                meta=Metadata(name=f"p{j:05d}-{t}", namespace="default", annotations=dict(ann)),
                spec=PodSpec(resources=Resource(float(cpus[k]), float(mems[k])))))
            k += 1
        if j < n_best_effort:
            store.create("Pod", Pod(
                meta=Metadata(name=f"be{j:05d}", namespace="default", annotations=dict(ann)),
                spec=PodSpec(resources=Resource())))
    return store


def check_placement(store):
    """No node over its allocatable or pod cap; every gang all-or-nothing.
    Returns (gang tasks bound, best-effort pods bound)."""
    nodes = {n.meta.name: i for i, n in enumerate(store.list("Node"))}
    cap = np.array([[n.allocatable.milli_cpu, n.allocatable.memory,
                     n.allocatable.max_task_num] for n in store.list("Node")])
    used = np.zeros_like(cap)
    per_gang = {}
    be_bound = 0
    for p in store.list("Pod"):
        if not p.node_name:
            continue
        i = nodes[p.node_name]
        used[i] += (p.spec.resources.milli_cpu, p.spec.resources.memory, 1)
        if p.meta.name.startswith("be"):
            be_bound += 1
        else:
            g = p.meta.name.split("-")[0]
            per_gang[g] = per_gang.get(g, 0) + 1
    over = np.nonzero((used > cap).any(axis=1))[0]
    if over.size:
        raise AssertionError(f"{over.size} nodes over capacity, e.g. row {over[0]}")
    partial = {g: c for g, c in per_gang.items() if c != CFG5["tasks_per_job"]}
    if partial:
        raise AssertionError(f"gangs bound partially: {list(partial.items())[:5]}")
    return sum(per_gang.values()), be_bound


def phase_e2e(label, n_jobs, n_best_effort, want, forbid):
    """Drive Scheduler.run_once on the card; returns the launch counts of
    the first cycle (reset just before it, read just after)."""
    import torch

    from volcano_tpu_torch.scheduler import kernels as K
    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    t0 = time.perf_counter()
    store = build_cfg5_store(n_jobs, n_best_effort)
    log(f"[{label}] store built: {CFG5['nodes']} nodes, {n_jobs} gangs x "
        f"{CFG5['tasks_per_job']}, {n_best_effort} best-effort ({time.perf_counter() - t0:.1f} s)")
    sched = Scheduler(store, conf=full_conf("cuda"))
    log(f"[{label}] prewarm {sched.prewarm():.2f} s")
    K.reset_launches()
    t0 = time.perf_counter()
    sched.run_once()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    phases = {k: round(v, 4) for k, v in sched.fast_cycle.phases.items()}
    log(f"[{label}] cycle 1 wall {wall:.3f} s phases {json.dumps(phases)} launches {launches}")
    for name in want:
        if launches[name] < 1:
            raise AssertionError(f"{label}: kernel {name} not launched on the main path")
    for name in forbid:
        if launches[name]:
            raise AssertionError(f"{label}: kernel {name} launched ({launches[name]})")
    gang, be = check_placement(store)
    log(f"[{label}] bound after cycle 1: {gang} gang tasks, {be} best-effort")
    if gang < n_jobs * CFG5["tasks_per_job"] or be < n_best_effort:
        t0 = time.perf_counter()
        sched.run_once()
        log(f"[{label}] cycle 2 wall {time.perf_counter() - t0:.3f} s")
        gang, be = check_placement(store)
        log(f"[{label}] bound after cycle 2: {gang} gang tasks, {be} best-effort")
    if gang != n_jobs * CFG5["tasks_per_job"] or be != n_best_effort:
        raise AssertionError(f"{label}: {gang} gang tasks and {be} best-effort bound")
    t0 = time.perf_counter()
    sched.run_once()
    steady = time.perf_counter() - t0
    log(f"[{label}] steady cycle wall {steady:.4f} s phases "
        f"{json.dumps({k: round(v, 4) for k, v in sched.fast_cycle.phases.items()})}")
    return launches


def _device_ms(events):
    """{name: (calls, device ms)} of profiler key averages, device time only."""
    out = {}
    for e in events:
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t:
            out[e.key] = (e.count, t / 1e3)
    return out


def phase_profile(out_path=None):
    """torch.profiler over one config-5 batch solve and one config-5 cycle:
    device time by kernel and the device's busy share of the cycle wall;
    the numbers also go to ``out_path`` as JSON when given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from volcano_tpu_torch.scheduler import kernels as K
    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler
    from volcano_tpu_torch.scheduler.simargs import build_sim_args

    dev = torch.device("cuda")
    a = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in build_sim_args(10_000, 100_000, 5_000).items()}
    des = K.water_fill(a["queue_weight"], a["queue_request"], a["total"], a["eps"],
                       a["queue_participates"])
    args = [des if k == "queue_deserved" else a[k] for k in K._SOLVE_ARGS] + [1.0, 1.0]
    K.allocate_solve_batch(*args)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = K.allocate_solve_batch(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    solve = _device_ms(prof.key_averages())
    rounds = int(out.steps)
    busy = sum(ms for _, ms in solve.values())
    log(f"[profile] batch solve: wall {wall * 1e3:.3f} ms, {rounds} rounds, "
        f"device {busy:.3f} ms ({busy / (wall * 1e3):.3f} busy)")
    for name, (calls, ms) in sorted(solve.items(), key=lambda kv: -kv[1][1]):
        log(f"[profile]   {name}: {calls} calls, {ms:.3f} ms")

    store = build_cfg5_store()
    sched = Scheduler(store, conf=full_conf("cuda"))
    sched.prewarm()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sched.run_once()
        torch.cuda.synchronize()
        cwall = time.perf_counter() - t0
    cycle = _device_ms(prof.key_averages())
    cbusy = sum(ms for _, ms in cycle.values())
    phases = dict(sched.fast_cycle.phases)
    log(f"[profile] cycle: wall {cwall:.3f} s, device {cbusy:.3f} ms, idle share "
        f"{1 - cbusy / (cwall * 1e3):.5f}, phases {json.dumps(phases)}")
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"solve_wall_ms": wall * 1e3, "rounds": rounds, "solve_device": solve,
                       "cycle_wall_s": cwall, "cycle_device": cycle, "cycle_phases": phases},
                      f, indent=1)


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    smi = phase_build()
    if "--profile" in argv:
        i = argv.index("--profile") + 1
        phase_profile(argv[i] if i < len(argv) else None)
    kern = phase_kernels()
    phase_kernel_sweep()
    batch = phase_e2e("e2e batch", CFG5["jobs"], CFG5["best_effort"],
                      want=("water_fill", "allocate_solve_batch"),
                      forbid=("allocate_solve",))
    exact = phase_e2e("e2e exact", 200, 0,
                      want=("water_fill", "allocate_solve"),
                      forbid=("allocate_solve_batch",))
    for name, row in kern.items():
        row["launches"] = exact[name] if name == "allocate_solve" else batch[name]
        row["check"] = "ok"
    log(smi)
    log(json.dumps({"kernels": list(kern.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

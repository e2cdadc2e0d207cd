"""Multi-controller cycle (K13): one process per host, each host feeding and
fetching only its shard of the task and node planes.

The port of ``volcano_tpu/parallel/multihost.py`` on the node blocks of
``parallel/sharded.py`` (K12a):

* a 2-D ``(hosts, nodes)`` mesh: D node blocks grouped into H hosts of
  D / H blocks.  Node planes split over both axes together, into the same D
  blocks as the 1-D mesh, so ``H = 1`` is the sharded cycle, and every H
  gives its outputs bit for bit;
* task planes (``task_req``, ``task_job``, ``task_class``, ``task_valid``)
  split over the hosts only, in ``host_bounds``' ceil-blocks, and are
  gathered back into global row order before the solve: a ``torch.cat`` on
  one device, an all-gather along the host axis over a process group;
* job, queue and the packed bitset planes replicate;
* each host fetches only what it owns (``owned_output_slices``): task
  outputs by task block, node outputs by node block, and host 0 the global
  job, queue and scalar outputs.

Two meshes behind ``make_host_mesh``:

* ``LocalHostMesh``: the D blocks on this process's one device.
  ``run_lockstep`` runs the H hosts in one process: each host's build
  (``host_plane_shard``), dispatch (its uploads) and owned fetch are timed
  on their own; the solve between them is the same global program at every
  H and is reported as ``solve_wait_s``;
* ``GroupHostMesh``: a process group of H x P ranks, rank ``h * P + d``
  holding blocks of host h; the task gather runs in one group per node
  column d, along the host axis (every rank creates every group, in the
  same order).

Process mode (``python -m volcano_tpu_torch.parallel.multihost``) runs one
OS process per host in lockstep over identically seeded arguments, with
the JAX module's rendezvous directory and degrade contract: a dead
coordinator degrades a worker to a full single-host cycle (``"fallback":
true``); a dead, late or wrong worker degrades the coordinator to its own
full outputs (``"degraded": true``).  ``--backend cuda`` (the default) runs
on the card and raises without one; ``--backend cpu`` runs the plain
versions.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from volcano_tpu_torch import vtprof
from volcano_tpu_torch.parallel import sharded as S
from volcano_tpu_torch.scheduler import kernels as K

#: the cycle's outputs, in order (``parallel/sharded.py``'s)
OUTPUT_NAMES = S.OUTPUT_NAMES
#: output indices by owner: task outputs by task block, node outputs by
#: node block; the rest (job, queue, scalars) only host 0 fetches
_TASK_OUT = (0, 1, 2)
_NODE_OUT = (6, 7, 8)
_GLOBAL_OUT = (3, 4, 5, 9, 10)

#: argument name -> (mesh axes, array axis).  Node planes split over
#: ("hosts", "nodes") together along their node axis (the D blocks of the
#: 1-D mesh); task planes split over "hosts" along axis 0
_SPECS: Dict[str, Tuple[str, int]] = {
    "idle": ("hosts,nodes", 0),
    "releasing": ("hosts,nodes", 0),
    "used": ("hosts,nodes", 0),
    "node_alloc": ("hosts,nodes", 0),
    "node_max_tasks": ("hosts,nodes", 0),
    "task_count": ("hosts,nodes", 0),
    "node_valid": ("hosts,nodes", 0),
    "class_mask": ("hosts,nodes", 1),
    "class_score": ("hosts,nodes", 1),
    "node_ports_w": ("hosts,nodes", 0),
    "node_selcnt": ("hosts,nodes", 0),
    "task_req": ("hosts", 0),
    "task_job": ("hosts", 0),
    "task_class": ("hosts", 0),
    "task_valid": ("hosts", 0),
}

#: cycle arguments that replicate on every host; a name in neither table
#: raises
_REPLICATED = frozenset({
    "job_queue", "job_min", "job_prio", "job_ready_init",
    "job_alloc_init", "job_schedulable", "job_start", "job_ntasks",
    "queue_weight", "queue_request", "queue_alloc_init",
    "queue_participates",
    "total", "eps",
    "task_volmask_w", "task_claims", "claim_group", "group_cap",
    "group_global",
    "task_ports_w", "task_aff_w", "task_anti_w", "task_self_w",
})

_TASK_PLANES = tuple(k for k, (axes, _) in _SPECS.items() if axes == "hosts")

#: node blocks of the process mode's mesh (more when there are more hosts)
N_BLOCKS = 4

#: multihost cycles run on the card since the last ``reset_launches()``
#: (each launches K1 and K12a's kernels)
LAUNCHES: Dict[str, int] = {"multihost_cycle": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def host_bounds(n_rows: int, n_hosts: int) -> List[Tuple[int, int]]:
    """Per-host ``[lo, hi)`` bounds over an ``n_rows`` axis in the JAX
    ceil-block convention: host h owns ``[h * q, (h + 1) * q)`` clipped to
    ``n_rows``, q = ceil(n_rows / n_hosts)."""
    n_hosts = max(int(n_hosts), 1)
    q = -(-int(n_rows) // n_hosts)
    return [(min(h * q, n_rows), min((h + 1) * q, n_rows)) for h in range(n_hosts)]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class LocalHostMesh(S.LocalMesh):
    """D node blocks on this process's one device, grouped into H hosts of
    D / H blocks; task planes are held as the tuple of the H host blocks."""

    def __init__(self, n_hosts: int, n_blocks: int, device):
        super().__init__(n_blocks, device)
        if n_hosts < 1 or n_blocks % n_hosts:
            raise ValueError(f"{n_blocks} node blocks do not divide into {n_hosts} hosts")
        self.hosts = n_hosts
        self.per_host = n_blocks // n_hosts
        #: this process holds every host's rows
        self.host = None

    def gather_tasks(self, parts, n_rows: int) -> torch.Tensor:
        return parts[0] if len(parts) == 1 else torch.cat(list(parts))

    def __repr__(self) -> str:
        return f"LocalHostMesh({self.hosts} hosts x {self.per_host} blocks on {self.device})"


class GroupHostMesh(S.GroupMesh):
    """A process group of H x P ranks: rank ``h * P + d`` is column d of
    host h and holds D / (H P) node blocks (``GroupMesh``'s layout) and
    host h's task block."""

    def __init__(self, n_hosts: int, n_blocks: int, device=None):
        import torch.distributed as dist

        super().__init__(n_blocks, device)
        if n_hosts < 1 or self.world % n_hosts:
            raise ValueError(f"{self.world} ranks do not divide into {n_hosts} hosts")
        self.hosts = n_hosts
        self.cols = self.world // n_hosts
        self.host, self.col = divmod(self.rank, self.cols)
        # the task gather runs along the host axis: one group per column
        groups = [dist.new_group([h * self.cols + d for h in range(n_hosts)])
                  for d in range(self.cols)]
        self.task_group = groups[self.col]

    def gather_tasks(self, part: torch.Tensor, n_rows: int) -> torch.Tensor:
        import torch.distributed as dist

        q = -(-n_rows // self.hosts)
        # bools travel as bytes
        src = part.view(torch.uint8) if part.dtype == torch.bool else part
        pad = torch.zeros((q,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
        pad[:src.shape[0]] = src
        out = torch.empty((self.hosts * q,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(out, pad, group=self.task_group)
        out = out[:n_rows]
        return out.view(torch.bool) if part.dtype == torch.bool else out

    def __repr__(self) -> str:
        return (f"GroupHostMesh({self.hosts} hosts, {self.size} blocks, rank {self.rank} = "
                f"host {self.host} column {self.col}, {self.device})")


def make_host_mesh(n_hosts: int, n_blocks: int, device=None):
    """A (hosts, nodes) mesh of ``n_blocks`` node blocks in ``n_hosts``
    hosts: over the process group when one is initialised, else on
    ``device`` (the card by default) alone."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return GroupHostMesh(n_hosts, n_blocks, device)
    return LocalHostMesh(n_hosts, n_blocks, S.local_device(device))


def cycle_shardings(args: Dict[str, object]) -> Dict[str, str]:
    """The placement of each cycle argument: "hosts,nodes" (node blocks),
    "hosts" (task blocks) or "replicated"; a name in neither table raises."""
    undeclared = sorted(set(args) - set(_SPECS) - _REPLICATED)
    if undeclared:
        raise ValueError(f"cycle arguments with no declared multihost placement: {undeclared}")
    return {k: _SPECS[k][0] if k in _SPECS else "replicated" for k in args}


def shard_args(mesh, args: Dict[str, object]) -> Dict[str, object]:
    """Host arrays (or tensors) -> this process's placement: node planes as
    the tuple of its blocks; task planes as the tuple of every host's block
    on a local mesh, its own host's block over a group; the rest whole."""
    places = cycle_shardings(args)
    n_tasks = np.shape(args["task_req"])[0]
    bounds = host_bounds(n_tasks, mesh.hosts)
    out = {}
    for k, v in args.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
        t = t.to(mesh.device)
        if places[k] == "hosts,nodes":
            out[k] = S.split_rows(mesh, k, t)
        elif places[k] == "hosts":
            if mesh.host is None:
                out[k] = tuple(t[lo:hi].contiguous() for lo, hi in bounds)
            else:
                lo, hi = bounds[mesh.host]
                out[k] = t[lo:hi].contiguous()
        else:
            out[k] = t
    return out


def _cycle(mesh, dargs, n_tasks, w_least, w_balanced, job_key_order, use_gang_ready,
           use_proportion, m_chunk, p_chunk):
    """One decision cycle over the host mesh: the task planes gathered over
    the hosts back into global row order, then the sharded cycle (K1
    replicated, K12a on the node blocks)."""
    full = dict(dargs)
    for k in _TASK_PLANES:
        full[k] = mesh.gather_tasks(dargs[k], n_tasks)
    tok = None
    if vtprof.PROFILER is not None:  # disarmed, no launch key is built
        tok = vtprof.launch_begin("multihost_cycle", K._launch_key(
            dargs, job_key_order=tuple(job_key_order), use_gang_ready=use_gang_ready,
            use_proportion=use_proportion, m_chunk=m_chunk, p_chunk=p_chunk), mesh.device)
    out = S._cycle(mesh, full, w_least, w_balanced, job_key_order, use_gang_ready,
                   use_proportion, m_chunk, p_chunk)
    if mesh.device.type == "cuda":
        LAUNCHES["multihost_cycle"] += 1
    vtprof.launch_end(tok)
    return out


def make_multihost_cycle(mesh, args: Dict[str, object], w_least: float = 1.0,
                         w_balanced: float = 1.0, job_key_order=("priority", "gang", "drf"),
                         use_gang_ready: bool = True, use_proportion: bool = True,
                         m_chunk: int = 512, p_chunk: int = 16):
    """(fn, device_args): ``device_args`` places the host args on the host
    mesh (``shard_args``) and ``fn(device_args)`` runs one cycle; its node
    planes hold this process's rows, its task and global outputs are whole
    on every process (the decision is replicated)."""
    n_rows = np.shape(args["idle"])[0]
    if n_rows % mesh.size:
        raise ValueError(f"node bucket {n_rows} not divisible by mesh size {mesh.size}")
    device_args = shard_args(mesh, args)
    n_tasks = np.shape(args["task_req"])[0]

    def fn(dargs):
        return _cycle(mesh, dargs, n_tasks, w_least, w_balanced, job_key_order,
                      use_gang_ready, use_proportion, m_chunk, p_chunk)

    return fn, device_args


def owned_output_slices(out, host: int, n_hosts: int, mesh=None) -> Dict[str, np.ndarray]:
    """Fetch what ``host`` owns of the cycle's outputs: its task block of
    the task outputs, its node block of the node outputs, and on host 0 the
    global outputs.  Over a process group each rank fetches what it owns:
    its own node rows, its host's task block on the host's column 0, the
    global outputs on rank 0; ``merge_output_slices`` over the ranks in
    order then covers every row once."""
    T = out[0].shape[0]
    grouped = isinstance(mesh, GroupHostMesh)
    if grouped:
        tlo, thi = host_bounds(T, n_hosts)[host] if mesh.col == 0 else (0, 0)
        nlo, nhi = 0, out[_NODE_OUT[0]].shape[0]
        lead = mesh.rank == 0
    else:
        N = out[_NODE_OUT[0]].shape[0]
        tlo, thi = host_bounds(T, n_hosts)[host]
        nlo, nhi = host_bounds(N, n_hosts)[host]
        lead = host == 0
    picks = [(OUTPUT_NAMES[i], out[i][tlo:thi]) for i in _TASK_OUT]
    picks += [(OUTPUT_NAMES[i], out[i][nlo:nhi]) for i in _NODE_OUT]
    if lead:
        picks += [(OUTPUT_NAMES[i], out[i]) for i in _GLOBAL_OUT]
    # the per-host fetch boundary: armed, its wall rolls up under this
    # host's fetch_s
    arrs = vtprof.fetch_outputs([t for _, t in picks], kernel="multihost_cycle",
                                phase="fetch", host=host)
    return {name: a for (name, _), a in zip(picks, arrs)}


def merge_output_slices(per_host: List[Dict[str, np.ndarray]]) -> tuple:
    """The full output tuple from every host's owned slices, in host order
    (also the proof that the slices cover each output row once)."""
    merged = {}
    for i in _TASK_OUT + _NODE_OUT:
        name = OUTPUT_NAMES[i]
        merged[name] = np.concatenate([ph[name] for ph in per_host])
    for i in _GLOBAL_OUT:
        merged[OUTPUT_NAMES[i]] = per_host[0][OUTPUT_NAMES[i]]
    return tuple(merged[n] for n in OUTPUT_NAMES)


def run_lockstep(args: Dict[str, object], n_hosts: int, *, n_blocks: Optional[int] = None,
                 reps: int = 1, w_least: float = 1.0, w_balanced: float = 1.0,
                 job_key_order=("priority", "gang", "drf"), use_gang_ready: bool = True,
                 use_proportion: bool = True, m_chunk: int = 512, p_chunk: int = 16,
                 device=None, mesh: Optional[LocalHostMesh] = None):
    """One global multihost cycle on one device with each host's critical
    path measured on its own: host h's ``build_s`` is its
    ``host_plane_shard``, its ``dispatch_s`` the uploads of its shard (its
    node blocks, its task block, the replicated planes), its ``fetch_s``
    its ``owned_output_slices``; ``path_s`` is their sum.  The solve is the
    same global program at every H and is reported as ``solve_wait_s``.  On
    the card each wall ends with a ``torch.cuda.synchronize``.  ``n_blocks``
    node blocks in all (``n_hosts`` by default), on ``device`` (the card by
    default; the CPU runs the plain versions).

    Returns ``{"outputs": the merged 11-tuple (numpy), "per_host":
    [{build_s, dispatch_s, fetch_s, path_s}], "critical_path_s",
    "solve_wait_s", "n_hosts", "n_blocks"}``, the repetition with the
    shortest critical path of ``reps`` (the port compiles nothing at run
    time, so no repetition is a warm-up)."""
    from volcano_tpu_torch.scheduler.fastpath.snapshot_build import host_plane_shard

    if mesh is None:
        mesh = LocalHostMesh(n_hosts, n_blocks or n_hosts, S.local_device(device))
    H, dev = mesh.hosts, mesh.device
    cycle_shardings(args)
    n_tasks = np.shape(args["task_req"])[0]
    if np.shape(args["idle"])[0] % mesh.size:
        raise ValueError(f"node bucket {np.shape(args['idle'])[0]} not divisible by mesh "
                         f"size {mesh.size}")
    host_mesh = S.LocalMesh(mesh.per_host, dev)
    best = None
    for _ in range(max(int(reps), 1)):
        prof = vtprof.PROFILER
        if prof is not None:
            prof.begin_cycle()
        build_s, disp_s, fetch_s = [0.0] * H, [0.0] * H, [0.0] * H
        placed = []
        for h in range(H):
            t0 = time.perf_counter()
            shard = host_plane_shard(args, h, H)
            build_s[h] = time.perf_counter() - t0
            t0 = time.perf_counter()
            up = {}
            for k, v in shard.items():
                t = torch.from_numpy(v).to(dev)
                up[k] = (S.split_rows(host_mesh, k, t)
                         if _SPECS.get(k, ("",))[0] == "hosts,nodes" else t)
            _sync(dev)
            disp_s[h] = time.perf_counter() - t0
            placed.append(up)
        dargs = {}
        for k in args:
            axes = _SPECS.get(k, ("replicated",))[0]
            if axes == "hosts,nodes":
                dargs[k] = tuple(b for up in placed for b in up[k])
            elif axes == "hosts":
                dargs[k] = tuple(up[k] for up in placed)
            else:
                dargs[k] = placed[0][k]
        t0 = time.perf_counter()
        out = _cycle(mesh, dargs, n_tasks, w_least, w_balanced, job_key_order,
                     use_gang_ready, use_proportion, m_chunk, p_chunk)
        _sync(dev)
        wait_s = time.perf_counter() - t0
        slices = []
        for h in range(H):
            t0 = time.perf_counter()
            slices.append(owned_output_slices(out, h, H, mesh))
            fetch_s[h] = time.perf_counter() - t0
        path = [build_s[h] + disp_s[h] + fetch_s[h] for h in range(H)]
        if prof is not None:
            crit = int(np.argmax(path))
            # fetch_s rolls up at each host's fetch boundary
            # (owned_output_slices); the JAX lockstep adds it twice
            for h in range(H):
                prof.note_mesh_host(h, build_s=build_s[h], dispatch_s=disp_s[h])
            prof.end_cycle(path[crit], {"build": build_s[crit], "dispatch": disp_s[crit],
                                        "fetch": fetch_s[crit]}, "multihost")
        rec = {
            "outputs": merge_output_slices(slices),
            "per_host": [{"build_s": build_s[h], "dispatch_s": disp_s[h],
                          "fetch_s": fetch_s[h], "path_s": path[h]} for h in range(H)],
            "critical_path_s": max(path),
            "solve_wait_s": wait_s,
            "n_hosts": H,
            "n_blocks": mesh.size,
        }
        if best is None or rec["critical_path_s"] < best["critical_path_s"]:
            best = rec
    return best


# -- process mode: one OS process per host --------------------------------

def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


def _result_paths(outdir: str, host: int) -> Tuple[str, str]:
    return (os.path.join(outdir, f"host{host:02d}.json"),
            os.path.join(outdir, f"host{host:02d}.npz"))


def _device(ns) -> torch.device:
    if ns.backend == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--backend cuda needs a CUDA device and none is available; "
                           "pass --backend cpu to run the plain PyTorch versions")
    return S.local_device(ns.backend)


def _sim_args(ns):
    from volcano_tpu_torch.scheduler.simargs import build_sim_args

    return build_sim_args(n_nodes=ns.nodes, n_tasks=ns.tasks, n_jobs=ns.jobs, n_queues=2,
                          seed=ns.seed)


def _lockstep(ns, args, n_hosts, reps=None):
    return run_lockstep(args, n_hosts, n_blocks=max(N_BLOCKS, n_hosts),
                        reps=ns.reps if reps is None else reps, device=_device(ns))


def _worker(ns) -> int:
    """One mesh-host worker: run the lockstep cycle and ship its owned
    slices through the rendezvous directory.  A coordinator dead before or
    after the cycle degrades it to a full single-host cycle (``fallback``)
    that exits cleanly: degrade, don't wedge."""
    host = ns.host_id
    coord = ns.coordinator_pid or os.getppid()
    os.makedirs(ns.outdir, exist_ok=True)
    json_path, npz_path = _result_paths(ns.outdir, host)
    args = _sim_args(ns)
    fallback = not _pid_alive(coord)
    res = None
    if not fallback:
        res = _lockstep(ns, args, ns.mesh_hosts)
        # a coordinator dead mid-cycle reads no rendezvous: this host's
        # slices alone cannot carry the cluster
        fallback = not _pid_alive(coord)
    if fallback:
        res = _lockstep(ns, args, 1, reps=1)
    outs = res["outputs"]
    if fallback:
        own = {n: np.asarray(outs[i]) for i, n in enumerate(OUTPUT_NAMES)}
    else:
        tlo, thi = host_bounds(outs[0].shape[0], ns.mesh_hosts)[host]
        nlo, nhi = host_bounds(outs[6].shape[0], ns.mesh_hosts)[host]
        own = {OUTPUT_NAMES[i]: outs[i][tlo:thi] for i in _TASK_OUT}
        own.update({OUTPUT_NAMES[i]: outs[i][nlo:nhi] for i in _NODE_OUT})
    np.savez(npz_path + ".tmp.npz", **own)
    os.replace(npz_path + ".tmp.npz", npz_path)
    payload = {"host": host, "fallback": fallback, "per_host": res["per_host"],
               "critical_path_s": res["critical_path_s"]}
    with open(json_path + ".tmp", "w", encoding="utf-8") as f:
        json.dump(payload, f)
    os.replace(json_path + ".tmp", json_path)
    if not ns.quiet:
        print(json.dumps(payload))
    return 0


def _coordinator(ns) -> int:
    """Spawn one worker process per other host, run host 0's cycle, check
    every worker's shipped slices against the merged outputs.  A dead,
    late or wrong worker degrades the run to the coordinator's own full
    outputs (``degraded``) instead of wedging."""
    import subprocess
    import tempfile

    H = ns.mesh_hosts
    outdir = ns.outdir or tempfile.mkdtemp(prefix="vtmesh-")
    os.makedirs(outdir, exist_ok=True)
    if _device(ns).type == "cuda":
        # build the kernels once, before the workers look for them
        from volcano_tpu_torch import _build

        _build.load()
    base = [sys.executable, "-m", "volcano_tpu_torch.parallel.multihost",
            "--mesh-hosts", str(H), "--nodes", str(ns.nodes), "--tasks", str(ns.tasks),
            "--jobs", str(ns.jobs), "--seed", str(ns.seed), "--reps", str(ns.reps),
            "--backend", ns.backend, "--outdir", outdir,
            "--coordinator-pid", str(os.getpid()), "--quiet"]
    procs = [subprocess.Popen(base + ["--host-id", str(h)]) for h in range(1, H)]
    try:
        res = _lockstep(ns, _sim_args(ns), H)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait(timeout=10)
        raise
    outs = res["outputs"]
    degraded = False
    workers = []
    for h, p in zip(range(1, H), procs):
        row = {"host": h, "rc": None, "ok": False, "fallback": None}
        try:
            row["rc"] = p.wait(timeout=ns.timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)
            row["rc"] = -9
            degraded = True
            workers.append(row)
            continue
        json_path, npz_path = _result_paths(outdir, h)
        try:
            with open(json_path, encoding="utf-8") as f:
                wres = json.load(f)
            with np.load(npz_path) as shipped:
                row["fallback"] = bool(wres.get("fallback"))
                tlo, thi = host_bounds(outs[0].shape[0], H)[h]
                nlo, nhi = host_bounds(outs[6].shape[0], H)[h]
                ok = all(np.array_equal(shipped[OUTPUT_NAMES[i]], outs[i][tlo:thi])
                         for i in _TASK_OUT) and all(
                    np.array_equal(shipped[OUTPUT_NAMES[i]], outs[i][nlo:nhi])
                    for i in _NODE_OUT)
            row["ok"] = ok and row["rc"] == 0 and not row["fallback"]
            if not row["ok"]:
                degraded = True
        except (OSError, ValueError, KeyError):
            degraded = True
        workers.append(row)
    summary = {
        # degraded still completes the cycle on the coordinator's full
        # outputs; the flag is what a supervisor alarms on
        "ok": degraded or all(w["ok"] for w in workers),
        "hosts": H,
        "degraded": degraded,
        "workers": workers,
        "per_host": res["per_host"],
        "critical_path_s": res["critical_path_s"],
        "solve_wait_s": res["solve_wait_s"],
        "binds": int((np.asarray(outs[1]) == 1).sum()),
        "device": str(_device(ns)),
    }
    print(json.dumps(summary))
    return 0


def _run_sweep(ns) -> int:
    """In-process host sweep: the lockstep cycle at each host count, the
    per-host critical paths, the per-doubling ratios, the merged outputs'
    parity across host counts, and with ``--prof`` the vtprof attribution
    coverage."""
    hosts = [int(x) for x in str(ns.sweep).split(",") if x.strip()]
    args = _sim_args(ns)
    sweep, ref, parity = {}, None, True
    profiler = vtprof.arm() if ns.prof else None
    try:
        for H in hosts:
            res = _lockstep(ns, args, H)
            sweep[str(H)] = {"critical_path_s": res["critical_path_s"],
                             "solve_wait_s": res["solve_wait_s"], "per_host": res["per_host"]}
            if ref is None:
                ref = res["outputs"]
            else:
                parity = parity and all(np.array_equal(a, b)
                                        for a, b in zip(ref, res["outputs"]))
        coverage = (vtprof.attribution(profiler.payload())["coverage"]
                    if profiler is not None else None)
    finally:
        if profiler is not None:
            vtprof.disarm()
    scaling = {f"{hosts[i]}->{hosts[i + 1]}":
               sweep[str(hosts[i + 1])]["critical_path_s"]
               / max(sweep[str(hosts[i])]["critical_path_s"], 1e-9)
               for i in range(len(hosts) - 1)}
    print(json.dumps({"sweep": sweep, "scaling_per_doubling": scaling, "parity": parity,
                      "prof_coverage": coverage,
                      "binds": int((np.asarray(ref[1]) == 1).sum()), "n_nodes": ns.nodes,
                      "n_tasks": ns.tasks, "n_jobs": ns.jobs, "device": str(_device(ns))}))
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m volcano_tpu_torch.parallel.multihost",
        description="multi-controller mesh cycle runner (one process per host)")
    ap.add_argument("--mesh-hosts", type=int,
                    default=int(os.environ.get("VOLCANO_TPU_MESH_HOSTS", "1")))
    ap.add_argument("--host-id", type=int, default=None,
                    help="worker mode (spawned by the coordinator)")
    ap.add_argument("--sweep", default="", help="in-process host sweep, e.g. 1,2,4")
    ap.add_argument("--prof", action="store_true",
                    help="arm vtprof for the run (sweep mode): prof_coverage in the summary")
    ap.add_argument("--nodes", type=int, default=512)
    ap.add_argument("--tasks", type=int, default=2048)
    ap.add_argument("--jobs", type=int, default=128)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--backend", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--outdir", default="", help="rendezvous dir for worker results")
    ap.add_argument("--coordinator-pid", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--quiet", action="store_true")
    ns = ap.parse_args(argv)
    if ns.sweep:
        return _run_sweep(ns)
    if ns.host_id is not None:
        return _worker(ns)
    if ns.mesh_hosts > 1:
        return _coordinator(ns)
    # one host: one full cycle, the deployed single-host shape
    res = _lockstep(ns, _sim_args(ns), 1)
    print(json.dumps({"ok": True, "hosts": 1, "critical_path_s": res["critical_path_s"],
                      "binds": int((np.asarray(res["outputs"][1]) == 1).sum()),
                      "device": str(_device(ns))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

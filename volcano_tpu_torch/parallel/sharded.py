"""Node-sharded decision cycle (K12a): node state split into blocks of rows.

The port of ``volcano_tpu/parallel/sharded.py`` (``_cycle``,
``make_sharded_cycle``, ``run_cycle_reference``, ``resolve_mesh``) on
``torch.distributed``:

* every node-shaped plane (``_SPECS``: idle, releasing, used, allocatable
  ``[N, R]``, task counts, pod caps, validity ``[N]``, the class masks and
  scores ``[C, N]``, and the dynamic solve's resident port and selector
  planes) splits into S equal blocks of contiguous rows; task, job and
  queue planes replicate (``_REPLICATED``);
* the batched solve runs on the blocks (``kernels.batch_launch``, the same
  code as K3, which is the one-block case): each round every block scores
  its own rows, takes its K best nodes for each selected job and packs
  them into candidate records (value, row, feasible and idle-fit bits,
  task count, pod cap, idle and releasing); ONE all-gather of the records
  a round gives every block all of them; the merge, the proposals, the
  accept and the job, task and queue updates run replicated on the
  gathered records with no float atomics, so every block reaches the same
  winners; each block applies the winners and a dropped gang's rollback
  to the rows it owns.  The exact top-K over N is contained in the union
  of the blocks' top-Ks, so every block count gives the one-block run's
  outputs bit for bit (the JAX package's contract under
  ``exact_topk=True``; the port's batch solve is always exact);
* K1 (the water fill) runs replicated.

The victim solve of the object path's preempt and reclaim (K12b,
``make_sharded_victim_step``) splits the node planes of its constants and
state the same way (``_VICTIM_SPECS``) and keeps the [V] pool whole: each
block finds the best covered and the best valid node among its own rows,
ONE exchange of those records gives every block the same node, and every
block then ranks that node's pool rows itself, so the victims, the
replicated state and the owner block's rows equal the one-block solve's bit
for bit (``victim_kernels.victim_step_sharded``, ``victim_blocks_plain``).

A mesh has two transports behind one interface (``exchange``,
``gather_rows``):

* ``GroupMesh``: a process group (NCCL on the card, gloo on the CPU),
  S / world blocks a rank, the exchange an ``all_gather_into_tensor``;
* ``LocalMesh``: S blocks on this process's one device (NCCL refuses two
  ranks on one card), the exchange the records buffer itself, which every
  block wrote in place.

On CPU tensors the solve runs its plain PyTorch version
(``batch_blocks_plain``), per block with the same exchange; on CUDA
tensors it launches the kernels or raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from volcano_tpu_torch import vtprof
from volcano_tpu_torch.scheduler import kernels as K

#: sharded-solve launches on the card since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {"sharded_cycle": 0}

#: node-axis planes: argument name -> the axis its node rows lie on
_SPECS: Dict[str, int] = {
    "idle": 0, "releasing": 0, "used": 0, "node_alloc": 0,
    "node_max_tasks": 0, "task_count": 0, "node_valid": 0,
    "class_mask": 1, "class_score": 1,
    # the dynamic solve's resident port words and selector counts
    "node_ports_w": 0, "node_selcnt": 0,
}

#: cycle arguments that replicate, listed so that every input has a
#: declared placement (``shard_args`` refuses a name in neither table)
_REPLICATED = frozenset({
    "task_req", "task_job", "task_class", "task_valid",
    "job_queue", "job_min", "job_prio", "job_ready_init",
    "job_alloc_init", "job_schedulable", "job_start", "job_ntasks",
    "queue_weight", "queue_request", "queue_alloc_init",
    "queue_participates",
    "total", "eps",
    "task_ports_w", "task_aff_w", "task_anti_w", "task_self_w",
})

#: the node planes of VictimConsts and VictimState, each mapped to its node
#: axis as ``_SPECS`` maps the cycle's; the [V] pool and the job and queue
#: state replicate (``_VICTIM_REPLICATED``); a field in neither table raises
_VICTIM_SPECS: Dict[str, int] = {k: _SPECS[k] for k in (
    "node_alloc", "node_max_tasks", "node_valid", "class_mask", "class_score",
    "idle", "releasing", "used", "task_count")}
_VICTIM_REPLICATED = frozenset({
    "run_req", "run_node", "run_job", "run_prio", "run_rank", "run_evictable",
    "job_queue", "job_min", "queue_deserved", "total", "eps", "w_least", "w_balanced",
    "run_live", "job_alloc", "job_occupied", "queue_alloc",
})

#: the solve's input names for the node planes (``kernels.NODE_PLANES``)
#: and the two K5 planes
_PLANE_OF = {"node_ports_w": "node_ports", "node_selcnt": "node_selcnt"}

#: most blocks a local mesh takes: each block costs three launches a round
MAX_LOCAL_BLOCKS = 64

OUTPUT_NAMES = ("task_node", "task_kind", "task_seq", "ready", "job_alloc",
                "queue_alloc", "idle", "releasing", "used", "dropped", "rounds")
#: outputs whose rows are node rows: each process holds its blocks' rows
_NODE_OUTPUTS = ("idle", "releasing", "used")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _all_gather(out: torch.Tensor, inp: torch.Tensor) -> None:
    import torch.distributed as dist

    # newer releases deprecate all_gather_into_tensor for all_gather_single
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp)


class LocalMesh:
    """S node blocks on this process's one device."""

    def __init__(self, n_blocks: int, device: torch.device):
        if n_blocks < 1 or n_blocks & (n_blocks - 1) or n_blocks > MAX_LOCAL_BLOCKS:
            raise ValueError(f"a local mesh takes a power of two up to {MAX_LOCAL_BLOCKS} "
                             f"blocks, got {n_blocks}")
        self.size = n_blocks
        self.device = torch.device(device)
        self.world, self.rank = 1, 0
        self.n_local, self.first = n_blocks, 0

    def exchange(self, send: torch.Tensor) -> torch.Tensor:
        return send

    def gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        return local

    def __repr__(self) -> str:
        return f"LocalMesh({self.size} blocks on {self.device})"


class GroupMesh:
    """The default torch.distributed process group: ``n_blocks / world``
    blocks a rank, rank r holding blocks [r * n_local, (r + 1) * n_local)."""

    def __init__(self, n_blocks: int, device: Optional[torch.device] = None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("a group mesh needs an initialised process group")
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        if n_blocks < self.world or n_blocks % self.world or n_blocks & (n_blocks - 1):
            raise ValueError(f"mesh of {n_blocks} blocks over {self.world} ranks: the block "
                             "count must be a power of two and a multiple of the world size")
        self.size = n_blocks
        self.n_local = n_blocks // self.world
        self.first = self.rank * self.n_local
        backend = dist.get_backend()
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                      else torch.device("cpu"))
        self.device = torch.device(device)
        if (backend == "nccl") != (self.device.type == "cuda"):
            raise ValueError(f"a {backend} group cannot exchange {self.device} tensors")

    def exchange(self, send: torch.Tensor) -> torch.Tensor:
        out = torch.empty((self.world * send.shape[0],) + tuple(send.shape[1:]),
                          dtype=send.dtype, device=send.device)
        _all_gather(out, send.contiguous())
        return out

    def gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        return self.exchange(local)

    def __repr__(self) -> str:
        return (f"GroupMesh({self.size} blocks, rank {self.rank} of {self.world}, "
                f"{self.device})")


def local_device(device=None) -> torch.device:
    """``device``, or the card when None; a CUDA device with no card
    raises, never running on the CPU in its place."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh on the card needs a CUDA device and none is available; "
                               "pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_blocks: Optional[int] = None, device=None):
    """A mesh of ``n_blocks`` node blocks: over the process group when one
    is initialised (one block a rank by default), else on ``device`` (the
    card by default) alone."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return GroupMesh(n_blocks or dist.get_world_size(), device)
    return LocalMesh(n_blocks or 1, local_device(device))


def resolve_mesh(setting: Optional[str], device=None):
    """The scheduler-conf ``mesh:`` key -> a mesh, or None (one block).

    "off" / None / "" -> None; "auto" -> the process group's world size
    (rounded down to a power of two), or 1 with no group; "N" -> N blocks:
    N / world a rank under a process group, else all N on ``device``.  A
    size-1 result resolves to None; a request that cannot be honoured (not
    a power of two, fewer blocks than ranks or not a multiple of them, more
    than a local mesh takes) raises, never running on one block in
    silence."""
    import torch.distributed as dist

    if not setting or setting == "off":
        return None
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    if setting == "auto":
        n = world
        while n & (n - 1):
            n -= 1
    else:
        try:
            n = int(setting)
        except ValueError:
            raise ValueError(f"mesh must be 'off', 'auto' or a block count, got {setting!r}")
        if n < 1 or n & (n - 1):
            raise ValueError(f"mesh: {setting} is not a power of two: snapshot node axes "
                             "bucket to powers of two, so it could never divide them")
        if grouped and (n < world or n % world):
            raise ValueError(f"mesh: {setting} blocks cannot spread over {world} ranks")
        if not grouped and n > MAX_LOCAL_BLOCKS:
            raise ValueError(f"mesh: {setting} blocks requested, a local mesh takes at most "
                             f"{MAX_LOCAL_BLOCKS}")
    if n <= 1:
        return None
    return make_mesh(n, device)


def split_rows(mesh, name: str, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """This process's blocks of a node-axis plane, each contiguous."""
    axis = _SPECS[name]
    n = x.shape[axis]
    if n % mesh.size:
        raise ValueError(f"{name}: {n} node rows do not divide into {mesh.size} blocks")
    nb = n // mesh.size
    return tuple(x.narrow(axis, (mesh.first + i) * nb, nb).contiguous()
                 for i in range(mesh.n_local))


def shard_args(mesh, args: Dict[str, object]) -> Dict[str, object]:
    """Host arrays (or tensors) -> this process's placement on the mesh's
    device: node-axis planes as a tuple of its blocks, everything else
    whole."""
    undeclared = sorted(set(args) - set(_SPECS) - _REPLICATED)
    if undeclared:
        raise ValueError(f"cycle arguments with no declared placement: {undeclared}")
    out = {}
    for k, v in args.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
        t = t.to(mesh.device)
        out[k] = split_rows(mesh, k, t) if k in _SPECS else t
    return out


def _blocks(mesh, planes: Dict[str, Tuple[torch.Tensor, ...]]):
    """[(n0, {plane: block})] of this process, from per-plane block tuples
    keyed by ``_SPECS`` names."""
    nb = planes["idle"][0].shape[0]
    out = []
    for i in range(mesh.n_local):
        blk = {_PLANE_OF.get(k, k): v[i] for k, v in planes.items()}
        out.append(((mesh.first + i) * nb, blk))
    return out


def sharded_solve(mesh, planes, repl, w_least, w_balanced,
                  job_key_order=("priority", "gang", "drf"), use_gang_ready=True,
                  use_proportion=True, m_chunk=512, p_chunk=16, portsel_task=None):
    """The batched allocate solve over the mesh's node blocks.

    ``planes``: node-axis planes by ``_SPECS`` name, each a tuple of this
    process's blocks; ``repl``: the replicated solve inputs with
    ``queue_deserved``; ``portsel_task``: K5's task words and weight
    ``(task_ports, task_aff, task_anti, task_self, w_podaff)`` as int32
    words (the node planes then include ``node_ports_w`` /
    ``node_selcnt``).  CPU tensors run ``batch_blocks_plain``; CUDA tensors
    launch K3's kernels on the blocks.  Returns a ``SolveOut`` whose node
    planes are this process's rows."""
    blocks = _blocks(mesh, planes)
    dev = repl["task_req"].device
    args = (repl, blocks, mesh.size, mesh.exchange, w_least, w_balanced, job_key_order,
            use_gang_ready, use_proportion, m_chunk, p_chunk, portsel_task)
    tok = None
    if vtprof.PROFILER is not None:  # disarmed, no launch key is built
        tok = vtprof.launch_begin("sharded_cycle", K._launch_key(
            repl, planes, portsel_task, job_key_order=tuple(job_key_order),
            use_gang_ready=use_gang_ready, use_proportion=use_proportion, m_chunk=m_chunk,
            p_chunk=p_chunk), dev)
    vtprof.count_dispatch("allocate_solve_batch")
    if dev.type == "cpu":
        return batch_blocks_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"sharded solve: unsupported device {dev}")
    from volcano_tpu_torch import _build

    out = K.batch_launch(_build.load(), K._stream(dev), *args)
    LAUNCHES["sharded_cycle"] += 1
    K.LAUNCHES["allocate_solve_batch"] += 1
    if portsel_task is not None:
        K.LAUNCHES["allocate_solve_batch_portsel"] += 1
    vtprof.launch_end(tok)
    return out


# --------------------------------------------------------------------------
# the plain version: per block, with the same exchange
# --------------------------------------------------------------------------

def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.float32)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def batch_blocks_plain(a, blocks, n_blocks, exchange, w_least, w_balanced,
                       job_key_order=("priority", "gang", "drf"), use_gang_ready=True,
                       use_proportion=True, m_chunk=512, p_chunk=16, task_words=None):
    """The plain PyTorch version of ``kernels.batch_launch`` (same
    arguments): ``kernels.allocate_solve_batch_plain`` with every node
    plane held per block, the candidate records exchanged each round and
    the decision taken from them."""
    dev = a["task_req"].device
    L = len(blocks)
    NB = blocks[0][1]["idle"].shape[0]
    N = NB * n_blocks
    T, R = a["task_req"].shape
    J = a["job_queue"].shape[0]
    Q = a["queue_alloc_init"].shape[0]
    M, P, Kk = min(m_chunk, J), p_chunk, min(p_chunk, N)
    F = M * P
    W = K.record_words(R)
    i32 = torch.int32
    jidx = torch.arange(J, device=dev)
    job_queue, job_start, job_ntasks = a["job_queue"], a["job_start"], a["job_ntasks"]
    task_req, task_job, task_valid = a["task_req"], a["task_job"], a["task_valid"]
    eps, total = a["eps"], a["total"]
    queue_deserved = a["queue_deserved"]
    jq_c = job_queue.clamp(0, Q - 1).long()
    offs = torch.arange(P, device=dev)
    rank = torch.arange(F, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def pad(x, fill=0):
        return torch.cat([x, torch.full((1,) + x.shape[1:], fill, dtype=x.dtype, device=dev)])

    ps = None
    if task_words is not None:
        ps = K._unpack_portsel((torch.zeros((1, K.PORT_WORDS), dtype=i32, device=dev),
                                task_words[0], torch.zeros((1, 32 * K.SEL_WORDS), device=dev),
                                *task_words[1:]))
    # replicated state
    ja, ready = a["job_alloc_init"].clone(), a["job_ready_init"].clone()
    cursor = torch.zeros(J, dtype=i32, device=dev)
    dropped = torch.zeros(J, dtype=torch.bool, device=dev)
    qa = a["queue_alloc_init"].clone()
    tn = torch.full((T,), -1, dtype=i32, device=dev)
    tk = torch.zeros(T, dtype=i32, device=dev)
    ts = torch.full((T,), -1, dtype=i32, device=dev)
    # per-block state and constants
    bs = []
    for n0, pl in blocks:
        b = {"n0": n0, "alloc": pl["node_alloc"], "cap": pl["node_max_tasks"],
             "valid": pl["node_valid"], "cmask": pl["class_mask"], "cscore": pl["class_score"],
             "idle": pl["idle"].clone(), "rel": pl["releasing"].clone(),
             "used": pl["used"].clone(), "tc": pl["task_count"].clone()}
        if ps is not None:
            b["ports"] = K.unpack_bits(pl["node_ports"])
            b["selcnt"] = pl["node_selcnt"].float()
        bs.append(b)
    rnd = 0
    progressed = True

    def active_mask():
        if use_proportion:
            q_ok = ~K.less_equal(queue_deserved, qa, eps)[jq_c]
        else:
            q_ok = torch.ones(J, dtype=torch.bool, device=dev)
        return a["job_schedulable"] & ~dropped & (cursor < job_ntasks) & (job_queue >= 0) & q_ok

    def local(b, tgt, mask):
        """Per block: a node row target as this block's row, or NB."""
        lt = tgt - b["n0"]
        return torch.where(mask & (lt >= 0) & (lt < NB), lt, NB).long()

    while True:
        active = active_mask()
        if not (progressed and bool(active.any())):
            break
        keys = [jidx.float()]
        keys += list(reversed(K._job_keys(job_key_order, a["job_prio"], ready, a["job_min"],
                                          ja, total)))
        if use_proportion:
            keys.append(K.dominant_share(qa, queue_deserved)[jq_c])
        keys.append((~active).to(torch.int8))
        order = K._lexsort(keys)
        sel = order[:M]
        sel_active = active[sel]
        head_t = (job_start[sel] + cursor[sel]).clamp(0, T - 1).long()
        head_req = task_req[head_t]
        head_cls = a["task_class"][head_t].long()

        # each block: its K best nodes a selected job, as records
        send = torch.stack([_block_records(b, head_req, head_cls, head_t, sel, sel_active, eps,
                                           w_least, w_balanced, ps, Kk, W)
                            for b in bs]).reshape(L, M * Kk * W)
        recv = exchange(send).reshape(n_blocks, M, Kk, W)

        # the merge: the job's top-K over every block's records
        cand = recv.permute(1, 0, 2, 3).reshape(M, n_blocks * Kk, W)
        by_row = torch.sort(cand[:, :, 1], dim=1, stable=True).indices
        vals = torch.gather(_f32(cand[:, :, 0]), 1, by_row)
        pick = torch.gather(by_row, 1, torch.sort(vals, dim=1, descending=True,
                                                  stable=True).indices)[:, :Kk]
        job_ok = ((recv[:, :, 0, 2] & 4) != 0).any(dim=0)
        rot = (torch.arange(Kk, device=dev)[None, :]
               + (torch.arange(M, device=dev) % Kk)[:, None]) % Kk
        pick = torch.gather(pick, 1, rot)
        top = torch.gather(cand, 1, pick[:, :, None].expand(M, Kk, W))  # [M, K, W]
        topk_nodes = top[:, :, 1].long()
        topk_feasible = (top[:, :, 2] & 1) != 0
        topk_is_idle = ((top[:, :, 2] & 2) != 0) & topk_feasible
        idle_k = _f32(top[:, :, 5:5 + R])
        req_safe = torch.clamp_min(head_req, 1e-30)[:, None, :]
        cnt = torch.floor((idle_k + eps) / req_safe)
        cnt = torch.where(head_req[:, None, :] > 0, cnt, K.POS_INF).amin(dim=-1)
        cnt = torch.where(topk_is_idle, torch.clamp_min(cnt, 0.0), zero)
        cnt = torch.where(topk_feasible & ~topk_is_idle, torch.ones_like(cnt), cnt)
        if ps is not None:
            spread = (ps.task_ports[head_t].any(dim=1)
                      | ((ps.task_anti[head_t] * ps.task_self[head_t]).sum(dim=1) > 0))
            cnt = torch.where(spread[:, None], torch.clamp_max(cnt, 1.0), cnt)
        cum_cnt = torch.cumsum(cnt, dim=1)
        slot = (offs[None, :, None].float() >= cum_cnt[:, None, :]).sum(dim=-1)
        in_range = slot < Kk
        slot_c = slot.clamp(0, Kk - 1)
        prop_node_mp = torch.gather(topk_nodes, 1, slot_c)
        prop_idle_mp = torch.gather(topk_is_idle, 1, slot_c)
        prop_rec = torch.gather(top, 1, slot_c[:, :, None].expand(M, P, W)).reshape(F, W)

        t_prop = job_start[sel][:, None] + cursor[sel][:, None] + offs[None, :]
        prop_valid = (
            sel_active[:, None] & job_ok[:, None]
            & (cursor[sel][:, None] + offs[None, :] < job_ntasks[sel][:, None]) & in_range
        )
        t_prop_c = t_prop.clamp(0, T - 1).long()
        p_valid = prop_valid.reshape(F)
        p_req = task_req[t_prop_c].reshape(F, R)
        p_node = prop_node_mp.reshape(F)
        p_is_idle = prop_idle_mp.reshape(F) & p_valid
        p_is_pipe = p_valid & ~p_is_idle
        p_job = sel[:, None].expand(M, P).reshape(F)
        p_t = t_prop_c.reshape(F)

        # capacity-aware acceptance over (node, rank)-sorted proposals,
        # against the records' node state
        key_node = torch.where(p_is_idle, p_node, N)
        order2 = torch.sort(key_node, stable=True).indices
        sn = key_node[order2]
        sreq = p_req[order2]
        seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sn[1:] != sn[:-1]])
        cum = torch.cumsum(sreq, dim=0)
        start_pos = torch.cummax(torch.where(seg_start, rank, 0), dim=0).values
        relcum = cum - (cum[start_pos] - sreq[start_pos])
        srec = prop_rec[order2]
        pos_in_seg = rank - start_pos
        accept_sorted = (
            torch.all(relcum < _f32(srec[:, 5:5 + R]) + eps, dim=-1)
            & (srec[:, 3] + pos_in_seg < srec[:, 4]) & (sn < N)
        )
        if ps is not None:
            p_ports, p_anti = ps.task_ports[p_t], ps.task_anti[p_t] > 0
            sbits = torch.cat([p_ports, ps.task_self[p_t] > 0], dim=1)[order2].int()
            inc = torch.cumsum(sbits, dim=0)
            excl = (inc - sbits - (inc[start_pos] - sbits[start_pos])) > 0
            PB = p_ports.shape[1]
            conflict = (
                torch.any(excl[:, :PB] & p_ports[order2], dim=1)
                | torch.any(excl[:, PB:] & p_anti[order2], dim=1)
            )
            accept_sorted = accept_sorted & ~conflict
        accept_idle = torch.zeros(F, dtype=torch.bool, device=dev)
        accept_idle[order2] = accept_sorted

        pipe_fits = (torch.all(p_req < _f32(prop_rec[:, 5 + R:5 + 2 * R]) + eps, dim=-1)
                     & (prop_rec[:, 3] < prop_rec[:, 4]))
        if ps is not None:
            p_is_pipe = p_is_pipe & ~(p_ports.any(dim=1) | p_anti.any(dim=1))
        pipe_node = torch.where(p_is_pipe & pipe_fits, p_node, N)
        best_rank_pipe = torch.full((N + 1,), F, dtype=torch.int64, device=dev)
        best_rank_pipe.scatter_reduce_(0, pipe_node, rank, reduce="amin")
        win_pipe = (best_rank_pipe[pipe_node] == rank) & p_is_pipe & pipe_fits

        win_mp = (accept_idle | win_pipe).reshape(M, P)
        prefix_ok = torch.cumsum((~win_mp).int(), dim=1) == 0
        win = (win_mp & prefix_ok).reshape(F)
        use_idle = accept_idle & win

        # replicated: job, task and queue state
        delta = torch.where(win[:, None], p_req, zero)
        job_tgt = torch.where(win, p_job, J)
        ja = pad(ja).index_add_(0, job_tgt, delta)[:J]
        ready = pad(ready).index_add_(0, job_tgt, use_idle.to(i32))[:J]
        cursor = pad(cursor).index_add_(0, job_tgt, win.to(i32))[:J]
        q_tgt = torch.where(win, jq_c[p_job], Q)
        qa = pad(qa).cpu().index_add_(0, q_tgt.cpu(), delta.cpu()).to(dev)[:Q]
        t_tgt = torch.where(win, p_t, T)
        tn2, tk2, ts2 = pad(tn), pad(tk), pad(ts)
        tn2[t_tgt] = torch.where(win, p_node, 0).to(i32)
        tk2[t_tgt] = torch.where(use_idle, 1, 2).to(i32)
        ts2[t_tgt] = (rnd * F + rank).to(i32)
        tn, tk, ts = tn2[:T], tk2[:T], ts2[:T]

        # each block: the winners on its own rows
        for b in bs:
            lt = local(b, p_node, win)
            b["idle"] = pad(b["idle"]).index_add_(0, torch.where(use_idle, lt, NB), -delta)[:NB]
            b["rel"] = pad(b["rel"]).index_add_(0, torch.where(win & ~use_idle, lt, NB),
                                                -delta)[:NB]
            b["used"] = pad(b["used"]).index_add_(0, lt, delta)[:NB]
            b["tc"] = pad(b["tc"]).index_add_(0, lt, win.to(i32))[:NB]
            if ps is not None:
                win_ports = torch.where(win[:, None], p_ports, False).int()
                b["ports"] = b["ports"] | (
                    torch.zeros((NB + 1, win_ports.shape[1]), dtype=i32, device=dev)
                    .index_add_(0, lt, win_ports)[:NB] > 0)
                b["selcnt"] = pad(b["selcnt"]).index_add_(
                    0, lt, torch.where(win[:, None], ps.task_self[p_t], zero))[:NB]

        # no win this round: drop the lowest-ranked active job, unwinding
        # its placements if it never reached gang readiness
        any_win = bool(win.any())
        n_active = int(active.sum())
        do_evict = (not any_win) and n_active > 0
        victim = int(order[max(n_active - 1, 0)])
        need_rb = do_evict and use_gang_ready and int(ready[victim]) < int(a["job_min"][victim])
        if do_evict:
            dropped[victim] = True
        if need_rb:
            rb_task = (task_job == victim) & (tk > 0) & task_valid
            rb_req = torch.where(rb_task[:, None], task_req, zero)
            t_node = tn.clamp(0, N - 1)
            for b in bs:
                lt = local(b, t_node, rb_task)
                b["idle"] = pad(b["idle"]).index_add_(
                    0, torch.where(tk == 1, lt, NB), rb_req)[:NB]
                b["rel"] = pad(b["rel"]).index_add_(0, torch.where(tk == 2, lt, NB), rb_req)[:NB]
                b["used"] = pad(b["used"]).index_add_(0, lt, -rb_req)[:NB]
                b["tc"] = pad(b["tc"]).index_add_(0, lt, -rb_task.to(i32))[:NB]
                if ps is not None:
                    rb_ports = torch.where(rb_task[:, None], ps.task_ports, False).int()
                    b["ports"] = b["ports"] & ~(
                        torch.zeros((NB + 1, rb_ports.shape[1]), dtype=i32, device=dev)
                        .index_add_(0, lt, rb_ports)[:NB] > 0)
                    b["selcnt"] = pad(b["selcnt"]).index_add_(
                        0, lt, -torch.where(rb_task[:, None], ps.task_self, zero))[:NB]
            q_rb = torch.zeros((Q + 1, R), dtype=torch.float32, device=dev).index_add_(
                0, torch.where(rb_task, jq_c[task_job.long()], Q), rb_req)
            qa = qa - q_rb[:Q]
            ja = ja.clone()
            ja[victim] = a["job_alloc_init"][victim]
            ready = ready.clone()
            ready[victim] = a["job_ready_init"][victim]
            cursor = cursor.clone()
            cursor[victim] = 0
            tn = torch.where(rb_task, -1, tn).to(i32)
            tk = torch.where(rb_task, 0, tk).to(i32)
            ts = torch.where(rb_task, -1, ts).to(i32)
        progressed = any_win or do_evict
        rnd += 1

    def rows(name):
        return bs[0][name] if L == 1 else torch.cat([b[name] for b in bs])

    return K.SolveOut(tn, tk, ts, ready, ja, qa, rows("idle"), rows("rel"), rows("used"),
                      dropped, torch.tensor(rnd, dtype=torch.int32, device=dev))


def _block_records(b, head_req, head_cls, head_t, sel, sel_active, eps, w_least, w_balanced,
                   ps, Kk, W):
    """One block's candidate records [M, K, W] int32: for each selected
    job, the block's K best nodes by (value desc, row asc), padded with
    (-inf, INT_MAX) when the block holds fewer rows."""
    dev = head_req.device
    NB = b["idle"].shape[0]
    M, R = head_req.shape
    fit_i = torch.all(head_req[:, None, :] < b["idle"][None, :, :] + eps, dim=-1)
    fit_r = torch.all(head_req[:, None, :] < b["rel"][None, :, :] + eps, dim=-1)
    pred = b["cmask"][head_cls] & (b["tc"] < b["cap"])[None, :] & b["valid"][None, :]
    feasible = (fit_i | fit_r) & pred & sel_active[:, None]
    if ps is not None:
        head_ports = ps.task_ports[head_t]
        head_aff, head_anti = ps.task_aff[head_t], ps.task_anti[head_t]
        matched = (b["selcnt"] > 0.5).float()
        port_overlap = head_ports.float() @ b["ports"].float().T
        req_missing = head_aff @ (1.0 - matched).T
        anti_hit = head_anti @ matched.T
        feasible = feasible & (port_overlap == 0) & (req_missing == 0) & (anti_hit == 0)
    score = K._score_nodes(head_req, b["used"], b["alloc"], b["cscore"][head_cls],
                           w_least, w_balanced)
    if ps is not None:
        score = K._fma(ps.w_podaff, (head_aff - head_anti) @ b["selcnt"].T, score)
    masked = torch.where(feasible, K._fma(K._jitter_bits(sel, NB, b["n0"]), K._JSCALE, score),
                         K.NEG_INF)
    any_b = feasible.any(dim=1)
    kb = min(Kk, NB)
    top = torch.sort(masked, dim=1, descending=True, stable=True).indices[:, :kb]
    flags = (torch.gather(feasible, 1, top).int() | (torch.gather(fit_i, 1, top).int() << 1)
             | (any_b.int() << 2)[:, None])
    rec = torch.zeros((M, Kk, W), dtype=torch.int32, device=dev)
    rec[:, :, 0] = _i32(torch.full((M, Kk), K.NEG_INF, device=dev))
    rec[:, :, 1] = 0x7FFFFFFF
    rec[:, :, 2] = (any_b.int() << 2)[:, None]
    rec[:, :kb, 0] = _i32(torch.gather(masked, 1, top))
    rec[:, :kb, 1] = (top + b["n0"]).int()
    rec[:, :kb, 2] = flags
    rec[:, :kb, 3] = b["tc"][top]
    rec[:, :kb, 4] = b["cap"][top]
    rec[:, :kb, 5:5 + R] = _i32(b["idle"][top])
    rec[:, :kb, 5 + R:5 + 2 * R] = _i32(b["rel"][top])
    return rec


# --------------------------------------------------------------------------
# the cycle
# --------------------------------------------------------------------------

_CYCLE_SOLVE = ("task_req", "task_job", "task_class", "task_valid", "job_queue", "job_min",
                "job_prio", "job_ready_init", "job_alloc_init", "job_schedulable",
                "job_start", "job_ntasks", "queue_alloc_init", "total", "eps")


def _cycle(mesh, dargs, w_least, w_balanced, job_key_order, use_gang_ready, use_proportion,
           m_chunk, p_chunk):
    """One decision cycle: the water fill (K1, replicated), then the
    batched allocate solve over the node blocks."""
    deserved = K.water_fill(dargs["queue_weight"], dargs["queue_request"], dargs["total"],
                            dargs["eps"], dargs["queue_participates"])
    repl = {k: dargs[k] for k in _CYCLE_SOLVE}
    repl["queue_deserved"] = deserved
    planes = {k: dargs[k] for k in K.NODE_PLANES}
    return sharded_solve(mesh, planes, repl, w_least, w_balanced, job_key_order,
                         use_gang_ready, use_proportion, m_chunk, p_chunk)


def run_cycle_reference(args, w_least=1.0, w_balanced=1.0,
                        job_key_order=("priority", "gang", "drf"), use_gang_ready=True,
                        use_proportion=True, m_chunk=512, p_chunk=16, device=None):
    """The unsharded cycle on ``device`` (the card by default; the parity
    oracle): K1, then ``kernels.allocate_solve_batch`` on whole planes."""
    dev = local_device(device)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in args.items()}
    deserved = K.water_fill(t["queue_weight"], t["queue_request"], t["total"], t["eps"],
                            t["queue_participates"])
    solve_in = [deserved if k == "queue_deserved" else t[k] for k in K._SOLVE_ARGS]
    return K.allocate_solve_batch(*solve_in, w_least, w_balanced, job_key_order=job_key_order,
                                  use_gang_ready=use_gang_ready, use_proportion=use_proportion,
                                  m_chunk=m_chunk, p_chunk=p_chunk)


def make_sharded_cycle(mesh, args: Dict[str, object], w_least: float = 1.0,
                       w_balanced: float = 1.0, job_key_order=("priority", "gang", "drf"),
                       use_gang_ready: bool = True, use_proportion: bool = True,
                       m_chunk: int = 512, p_chunk: int = 16):
    """(fn, device_args): ``device_args`` places the host args on the mesh
    (node planes split into this process's blocks, the rest whole) and
    ``fn(device_args)`` runs one cycle; its node-plane outputs hold this
    process's rows (``fetch_outputs`` gathers them)."""
    n_rows = np.shape(args["idle"])[0]
    if n_rows % mesh.size:
        raise ValueError(f"node bucket {n_rows} not divisible by mesh size {mesh.size}")
    device_args = shard_args(mesh, args)

    def fn(dargs):
        return _cycle(mesh, dargs, w_least, w_balanced, job_key_order, use_gang_ready,
                      use_proportion, m_chunk, p_chunk)

    return fn, device_args


def fetch_outputs(out, mesh=None) -> List[np.ndarray]:
    """A cycle's outputs on the host, in ``OUTPUT_NAMES`` order, with the
    node planes gathered over the mesh's ranks."""
    res = []
    for name, x in zip(OUTPUT_NAMES, out):
        if mesh is not None and name in _NODE_OUTPUTS:
            x = mesh.gather_rows(x)
        res.append(x)
    return list(vtprof.fetch_outputs(res, kernel="sharded_cycle", phase="solve"))


# --------------------------------------------------------------------------
# K12b: the victim solve on node blocks
# --------------------------------------------------------------------------

def _place_victim(mesh, tup):
    """A VictimConsts / VictimState of host arrays or tensors on the mesh's
    device: node planes as tuples of this process's blocks, the rest whole."""
    fields = {}
    for name in tup._fields:
        v = getattr(tup, name)
        if name in ("w_least", "w_balanced"):
            fields[name] = float(v)
            continue
        if name not in _VICTIM_SPECS and name not in _VICTIM_REPLICATED:
            raise ValueError(f"victim field {name!r} has no declared placement")
        t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v, copy=True))
        t = t.to(mesh.device)
        fields[name] = split_rows(mesh, name, t) if name in _VICTIM_SPECS else t
    return type(tup)(**fields)


def make_sharded_victim_step(mesh, consts, state, **static_kw):
    """(fn, dev_consts, dev_state): the victim solve on the mesh's node
    blocks.  ``dev_consts`` / ``dev_state`` place ``consts`` and ``state``
    (VictimConsts / VictimState of host arrays or tensors) with their node
    planes split into this process's blocks; ``fn(dev_consts, dev_state,
    t_req, t_cls, jt, qt)`` runs one preemptor's solve and returns
    ``(new_state, assigned, nstar, vmask, clean)`` after the one fetch of the
    decision (``vmask`` a numpy bool [V]); the new state's node planes stay
    in this process's blocks, so chained solves stay blocked.
    ``static_kw``: ``victim_step``'s mode and flags."""
    from volcano_tpu_torch.scheduler import victim_kernels as VK

    dev_consts = _place_victim(mesh, consts)
    dev_state = _place_victim(mesh, state)
    V = dev_consts.run_req.shape[0]

    def fn(c, s, t_req, t_cls, jt, qt):
        if not torch.is_tensor(t_req):
            t_req = torch.from_numpy(np.asarray(t_req, np.float32).copy())
        out = VK.victim_step_sharded(c, s, t_req.to(mesh.device), int(t_cls), int(jt),
                                     int(qt), mesh, **static_kw)
        if out.packed.device.type == "cuda":
            torch.cuda.synchronize(out.packed.device)
        assigned, nstar, vmask, clean = VK.unpack_step(out.packed.cpu().numpy(), V)
        return out.state, assigned, nstar, vmask, clean

    return fn, dev_consts, dev_state


def _kmin_better(ka, ia, kb, ib):
    """(key, row) lexicographic order; a row of -1 is no entry."""
    if ia < 0:
        return False
    return ib < 0 or ka < kb or (ka == kb and ia < ib)


def victim_blocks_plain(c, s, t_req, t_cls, jt, qt, mesh, nb, *, mode="queue", use_gang=True,
                        use_drf=False, use_prop=False, use_conformance=False,
                        order_by_priority=True, groups=None):
    """The plain PyTorch version of ``victim_kernels.victim_step_sharded``
    (same arguments): ``_blocks_core`` under the mode's base mask over the
    groups' orders, the decision packed."""
    from volcano_tpu_torch.scheduler import victim_kernels as VK

    reclaim = mode == "reclaim"
    groups = VK._step_groups("victim_step_sharded", c, s.run_live, groups, order_by_priority,
                             mesh)
    base = VK._step_base(c, s, jt, qt, mode)
    orders = VK._group_orders(c, groups, s.queue_alloc.shape[0], nb * mesh.size, reclaim,
                              use_drf, use_prop)
    flags = dict(use_gang=use_gang, use_drf=use_drf, use_prop=use_prop,
                 use_conformance=use_conformance)
    state, assigned, nstar, vmask, clean = _blocks_core(c, s, t_req, t_cls, jt, qt, base, orders,
                                                        flags, mesh, nb, reclaim)
    return VK.VictimStepOut(state, VK.pack_step(assigned, nstar, clean, vmask))


def _blocks_core(c, s, t_req, t_cls, jt, qt, base, orders, flags, mesh, nb, reclaim):
    """One preemptor's victim solve with the node planes of ``c`` and ``s``
    in this process's blocks (``victim_kernels._victim_core`` on blocks):
    each block's core over its own rows as a record, the mesh's exchange,
    the replicated merge, nstar's victims ranked again from the replicated
    pool, the replicated update and the owner block's rows.  Returns
    (new_state, assigned, nstar, vmask, clean), the new state's node planes
    again tuples of blocks."""
    from volcano_tpu_torch.scheduler import victim_kernels as VK

    dev = c.run_req.device
    V = c.run_req.shape[0]
    N = nb * mesh.size
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    node_g = torch.clamp(c.run_node, 0, N - 1)

    # each block: the lexicographic minima of its covered and valid nodes
    send = torch.zeros((mesh.n_local, VK.VB_WORDS), dtype=torch.int32, device=dev)
    for i in range(mesh.n_local):
        n0 = (mesh.first + i) * nb
        rows = (node_g >= n0) & (node_g < n0 + nb)
        cand, _ = VK._victim_flags(c, s, t_req, jt, base, *orders, rows=rows, **flags)
        tgt = torch.where(cand, node_g - n0, torch.full_like(node_g, nb))
        node_tot = VK._segment_sum(torch.where(cand[:, None], c.run_req, zero), tgt,
                                   nb + 1)[:nb]
        any_adm = VK._segment_count(cand, tgt, nb + 1)[:nb] > 0
        pred_ok = (c.node_valid[i] & c.class_mask[i][t_cls]
                   & (s.task_count[i] + 1 <= c.node_max_tasks[i]))
        valid = pred_ok & any_adm & ~torch.all(node_tot < t_req[None, :], dim=-1)
        covered = VK.less_equal(t_req[None, :], node_tot, c.eps) & valid
        if reclaim:
            walk = torch.arange(n0, n0 + nb, device=dev).float()
        else:
            walk = -VK._score_nodes(t_req, s.used[i], c.node_alloc[i], c.class_score[i][t_cls],
                                    c.w_least, c.w_balanced)
        for k, mask in ((0, covered), (2, valid)):
            if bool(mask.any()):
                kmin = torch.min(torch.where(mask, walk, torch.full_like(walk, VK.POS_INF)))
                row = int(torch.argmax((mask & (walk == kmin)).to(torch.int8)))
                send[i, k] = kmin.view(torch.int32)
                send[i, k + 1] = n0 + row
                send[i, 4 + k // 2] = 1
            else:
                send[i, k + 1] = -1
    recv = mesh.exchange(send)

    # the replicated merge
    kc = kv = 0.0
    ic = iv = -1
    for rec in recv.cpu().tolist():
        kr = torch.tensor(rec, dtype=torch.int32).view(torch.float32).tolist()
        if rec[4] and _kmin_better(kr[0], rec[1], kc, ic):
            kc, ic = kr[0], rec[1]
        if rec[5] and _kmin_better(kr[2], rec[3], kv, iv):
            kv, iv = kr[2], rec[3]
    assigned = ic >= 0
    nstar = ic if assigned else 0
    clean = (kv == kc and iv == ic) if assigned else iv < 0

    # nstar's victims, ranked again from the replicated pool
    vmask = torch.zeros(V, dtype=torch.bool, device=dev)
    if assigned:
        rows = node_g == nstar
        _, in_prefix = VK._victim_flags(c, s, t_req, jt, base, *orders, rows=rows, **flags)
        vmask = in_prefix & rows
    (run_live, job_alloc, job_occupied, queue_alloc), vsum, t_add = VK._victim_apply(
        c, s, t_req, jt, qt, assigned, vmask)
    # the owner block's rows
    releasing, used, task_count = [], [], []
    for i in range(mesh.n_local):
        rel, use, tc = s.releasing[i].clone(), s.used[i].clone(), s.task_count[i].clone()
        local = nstar - (mesh.first + i) * nb
        if assigned and 0 <= local < nb:
            VK._add_to_node(rel, use, tc, local, vsum, t_add, assigned)
        releasing.append(rel)
        used.append(use)
        task_count.append(tc)
    state = VK.VictimState(
        run_live=run_live, idle=s.idle, releasing=tuple(releasing),
        used=tuple(used), task_count=tuple(task_count), job_alloc=job_alloc,
        job_occupied=job_occupied, queue_alloc=queue_alloc)
    return state, assigned, nstar, vmask, clean


# --------------------------------------------------------------------------
# K15a-c: the contention solves on node blocks (plain versions)
# --------------------------------------------------------------------------

def reclaim_blocks_plain(c, s0, task_req, task_class, job_first, job_prio, job_cand0,
                         queue_live0, pipe0, mesh, nb, **kw):
    """The plain PyTorch version of ``victim_kernels.reclaim_solve_sharded``
    (same arguments): the reclaim walk with each attempt on the node blocks
    (``_blocks_core``)."""
    from volcano_tpu_torch.scheduler import victim_kernels as VK

    return VK.reclaim_solve_plain(c, s0, task_req, task_class, job_first, job_prio, job_cand0,
                                  queue_live0, pipe0, blocks=(mesh, nb), **kw)


def preempt_blocks_plain(c, s0, task_req, task_class, task_attempt, job_start, job_ntasks,
                         job_prio, job_avail0, under_request, nu, queues_order, nq, pipe0, mesh,
                         nb, **kw):
    """The plain PyTorch version of ``victim_kernels.preempt_solve_sharded``
    (same arguments): the preempt walk with each attempt on the node
    blocks; a discarded statement restores the blocks' rows with the rest
    of its checkpoint."""
    from volcano_tpu_torch.scheduler import victim_kernels as VK

    return VK.preempt_solve_plain(c, s0, task_req, task_class, task_attempt, job_start,
                                  job_ntasks, job_prio, job_avail0, under_request, nu,
                                  queues_order, nq, pipe0, blocks=(mesh, nb), **kw)


def rounds_blocks_plain(c, s0, task_req, task_class, rows_packed, job_pstart, job_pcount,
                        job_prio, job_avail0, pipe0, mesh, nb, *, use_gang, use_drf,
                        use_conformance, order_by_priority,
                        job_key_order=("priority", "gang", "drf"), gang_pipelined=True,
                        m_chunk=128, p_chunk=32, k_chunk=8):
    """The plain PyTorch version of ``victim_kernels.preempt_rounds_sharded``
    (same arguments): ``victim_kernels.preempt_rounds_plain`` with the node
    planes held per block.  Each round every block analyses its own pool
    rows (capacity curves of its (node, queue) cells) and packs its K best
    nodes for each selected job as records; one exchange; the proposals
    and the accept run replicated on the records; every block takes its
    cells' grants and its victims, whose per-job and per-queue sums (float64,
    exact) and rows travel in a second exchange and are added in block
    order."""
    from volcano_tpu_torch.scheduler import victim_kernels as VK

    dev = c.run_req.device
    V, R = c.run_req.shape
    L, S = mesh.n_local, mesh.size
    N = nb * S
    T = task_req.shape[0]
    J = c.job_queue.shape[0]
    Q = s0.queue_alloc.shape[0]
    M, P, Kk = min(m_chunk, J), p_chunk, min(k_chunk, N)
    F = M * P
    W = 5 + R
    i32 = dict(dtype=torch.int32, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    jidx = torch.arange(J, **i32)
    vidx = torch.arange(V, **i32)
    jq_c = torch.clamp(c.job_queue, 0, Q - 1)

    # static layouts, replicated: eviction order grouped per (node, queue)
    rq_pool = torch.clamp(c.job_queue[c.run_job], 0, Q - 1)
    prio_pool = c.run_prio if order_by_priority else torch.zeros_like(c.run_prio)
    o_ev = K._lexsort((vidx, -c.run_rank, prio_pool, rq_pool, c.run_node))
    inv_ev = torch.zeros(V, **i32)
    inv_ev[o_ev] = vidx
    sn2 = torch.clamp(c.run_node[o_ev], 0, N - 1)
    req_ev = c.run_req[o_ev]
    job_ev = c.run_job[o_ev]
    rq_ev_raw = c.job_queue[job_ev]
    has_q_ev = rq_ev_raw >= 0
    rq_ev = torch.clamp(rq_ev_raw, 0, Q - 1)
    seg_ev = VK._seg_flags(c.run_node[o_ev] * Q + rq_ev)
    last_ev = torch.ones(V, dtype=torch.bool, device=dev)
    last_ev[:-1] = seg_ev[1:]
    evictable_ev = c.run_evictable[o_ev]
    o_jb = K._lexsort((inv_ev, c.run_job))
    jb_seg = VK._seg_flags(c.run_job[o_jb])
    ar = torch.arange(V, device=dev)
    jb_start = torch.cummax(torch.where(jb_seg, ar, torch.zeros_like(ar)), dim=0).values
    cnt_in_job_pool = torch.zeros(V, **i32)
    cnt_in_job_pool[o_jb] = (ar - jb_start).int()
    cnt_in_job_ev = cnt_in_job_pool[o_ev]
    row_is_pre_ev = job_avail0[job_ev]
    if use_drf:
        o_drf, seg_drf = VK._orders_drf(c)
        ev_pos_drf = inv_ev[o_drf]
        inv_drf = torch.zeros(V, **i32)
        inv_drf[o_drf] = vidx
        drf_pos_ev = inv_drf[o_ev]
        req_drf = c.run_req[o_drf]
        job_drf = c.run_job[o_drf]
        has_q_drf = c.job_queue[job_drf] >= 0
        rq_drf = torch.clamp(c.job_queue[job_drf], 0, Q - 1)
        node_drf = torch.clamp(c.run_node[o_drf], 0, N - 1)

    # each block: its rows in those orders, its node planes
    bs = []
    for i in range(L):
        n0 = (mesh.first + i) * nb
        ev = torch.nonzero((sn2 >= n0) & (sn2 < n0 + nb)).flatten()
        b = dict(n0=n0, ev=ev, loc=((sn2[ev] - n0) * Q + rq_ev[ev]).long(),
                 node=(sn2[ev] - n0).long(), cmask=c.class_mask[i], cscore=c.class_score[i],
                 alloc=c.node_alloc[i], cap=c.node_max_tasks[i], valid=c.node_valid[i],
                 rel=s0.releasing[i].clone(), used=s0.used[i].clone(),
                 tc=s0.task_count[i].clone())
        if use_drf:
            b["drf"] = torch.nonzero((node_drf >= n0) & (node_drf < n0 + nb)).flatten()
        bs.append(b)

    run_live0 = torch.zeros(V, dtype=torch.bool, device=dev)
    run_live0[:] = s0.run_live
    live_ev = run_live0[o_ev].clone()
    job_alloc, job_occupied = s0.job_alloc.clone(), s0.job_occupied.clone()
    queue_alloc = s0.queue_alloc.clone()
    cursor = torch.zeros(J, **i32)
    pipe = pipe0.clone()
    dropped = torch.zeros(J, dtype=torch.bool, device=dev)
    evict_att = torch.full((V,), -1, **i32)
    pipe_node = torch.full((T,), -1, **i32)
    pipe_att = torch.full((T,), -1, **i32)
    att = att_total = last_v = round_ = 0
    any_commit = False
    progressed = True
    mask_at = J * R + Q * R + J + 1

    def active_mask():
        return job_avail0 & ~dropped & (cursor < job_pcount)

    while progressed and bool(active_mask().any()) and round_ < J + 8:
        active = active_mask()
        act_q = torch.zeros(Q, **i32)
        act_q.index_add_(0, jq_c.long(), (active & (c.job_queue >= 0)).int())
        act_q = act_q > 0
        head_t = rows_packed[torch.clamp(job_pstart + cursor, 0, T - 1)]
        head_req_all = task_req[torch.clamp(head_t, 0, T - 1)]
        budget = torch.where(c.job_min > 1, job_occupied - c.job_min,
                             torch.full_like(c.job_min, 2**31 - 1))
        if use_drf:
            ls_j = K.dominant_share(job_alloc + head_req_all, c.total)
            ls_q = torch.full((Q,), K.NEG_INF, dtype=torch.float32, device=dev)
            ls_q = ls_q.scatter_reduce(
                0, jq_c.long(), torch.where(active, ls_j, torch.full_like(ls_j, K.NEG_INF)),
                reduce="amax")

        # ---- each block: candidate analysis and its cells' capacity curves
        for b in bs:
            ev = b["ev"]
            cand = live_ev[ev] & act_q[rq_ev[ev]] & has_q_ev[ev] & ~row_is_pre_ev[ev]
            if use_conformance:
                cand &= evictable_ev[ev]
            if use_gang:
                cand &= cnt_in_job_ev[ev] < budget[job_ev[ev]]
            if use_drf:
                dr = b["drf"]
                base_drf = live_ev[ev_pos_drf[dr]] & act_q[rq_drf[dr]] & has_q_drf[dr]
                sreq = torch.where(base_drf[:, None], req_drf[dr], zero)
                relcum = VK._seg_cumsum(sreq, seg_drf[dr])
                rs = K.dominant_share(job_alloc[job_drf[dr]] - relcum, c.total)
                admit = torch.zeros(V, dtype=torch.bool, device=dev)
                admit[dr] = (ls_q[rq_drf[dr]] < rs + VK.SHARE_DELTA) & has_q_drf[dr]
                cand &= admit[drf_pos_ev[ev]]
            vr = torch.where(cand[:, None], req_ev[ev], zero)
            cum = VK._seg_cumsum(vr, seg_ev[ev])
            cap_flat = torch.zeros((nb * Q + 1, R), dtype=torch.float32, device=dev)
            cap_flat[torch.where(last_ev[ev], b["loc"], nb * Q)] = cum
            b.update(cand=cand, vr=vr, cum=cum, cap_flat=cap_flat[:nb * Q])

        # ---- job ranking (replicated)
        keys = [jidx.float()]
        for name in reversed(job_key_order):
            if name == "priority":
                keys.append(-job_prio.float())
            elif name == "gang":
                keys.append((job_occupied >= c.job_min).float())
            elif name == "drf":
                keys.append(K.dominant_share(job_alloc, c.total[None, :]))
        keys.append((~active).float())
        sel = K._lexsort(tuple(keys))[:M]
        sel_active = active[sel]
        head_req = head_req_all[sel]
        head_cls = task_class[torch.clamp(head_t[sel], 0, T - 1)]
        q_sel = jq_c[sel].long()

        # ---- each block: its K best nodes a selected job, as records
        send = torch.zeros((L, M, Kk, W), **i32)
        for i, b in enumerate(bs):
            n0 = b["n0"]
            cap_mnr = b["cap_flat"].reshape(nb, Q, R)[:, q_sel, :].transpose(0, 1)
            covered = torch.all(head_req[:, None, :] < cap_mnr + c.eps, dim=-1)
            pred = b["cmask"][head_cls] & (b["tc"] < b["cap"])[None, :] & b["valid"][None, :]
            feasible = covered & pred & sel_active[:, None]
            any_b = feasible.any(dim=1).int() << 1
            score = K._score_nodes(head_req, b["used"], b["alloc"], b["cscore"][head_cls],
                                   c.w_least, c.w_balanced)
            masked = torch.where(feasible, K._fma(K._jitter_bits(sel, nb, n0), K._JSCALE, score),
                                 torch.full_like(score, K.NEG_INF))
            kb = min(Kk, nb)
            top = torch.sort(masked, dim=1, descending=True, stable=True).indices[:, :kb]
            rec = send[i]
            rec[:, :, 0] = _i32(torch.full((M, Kk), K.NEG_INF, device=dev))
            rec[:, :, 1] = 0x7FFFFFFF
            rec[:, :, 2] = any_b[:, None]
            rec[:, :kb, 0] = _i32(torch.gather(masked, 1, top))
            rec[:, :kb, 1] = (top + n0).int()
            rec[:, :kb, 2] |= torch.gather(pred, 1, top).int()
            rec[:, :kb, 3] = b["tc"][top]
            rec[:, :kb, 4] = b["cap"][top]
            rec[:, :kb, 5:] = _i32(torch.gather(cap_mnr, 1, top[:, :, None].expand(M, kb, R)))
        recv = mesh.exchange(send.reshape(L, M * Kk * W)).reshape(S, M, Kk, W)

        # ---- the merge and the proposals (replicated)
        cand_r = recv.permute(1, 0, 2, 3).reshape(M, S * Kk, W)
        by_node = torch.sort(cand_r[:, :, 1], dim=1, stable=True).indices
        vals = torch.gather(_f32(cand_r[:, :, 0]), 1, by_node)
        pick = torch.gather(by_node, 1, torch.sort(vals, dim=1, descending=True,
                                                   stable=True).indices)[:, :Kk]
        job_ok = ((recv[:, :, 0, 2] & 2) != 0).any(dim=0)
        rot = (torch.arange(Kk, device=dev)[None, :]
               + (torch.arange(M, device=dev) % Kk)[:, None]) % Kk
        pick = torch.gather(pick, 1, rot)
        top = torch.gather(cand_r, 1, pick[:, :, None].expand(M, Kk, W))
        topk_nodes = top[:, :, 1].long()
        cap_k = _f32(top[:, :, 5:])
        topk_ok = (((top[:, :, 2] & 1) != 0) & sel_active[:, None]
                   & torch.all(head_req[:, None, :] < cap_k + c.eps, dim=-1))
        req_safe = torch.clamp_min(head_req, 1e-30)[:, None, :]
        cnt = torch.floor((cap_k + c.eps) / req_safe)
        cnt = torch.where(head_req[:, None, :] > 0, cnt, torch.full_like(cnt, K.POS_INF)).amin(-1)
        cnt = torch.where(topk_ok, torch.clamp_min(cnt, 0.0), torch.zeros_like(cnt))
        cum_cnt = torch.cumsum(cnt, dim=1)
        offs = torch.arange(P, device=dev)
        slot = (offs[None, :, None] >= cum_cnt[:, None, :]).sum(dim=-1)
        in_range = slot < Kk
        slot_c = torch.clamp(slot, 0, Kk - 1)
        prop_node_mp = torch.gather(topk_nodes, 1, slot_c)
        prop_rec = torch.gather(top, 1, slot_c[:, :, None].expand(M, P, W)).reshape(F, W)
        pofs = job_pstart[sel][:, None] + cursor[sel][:, None] + offs[None, :]
        prop_valid = (sel_active[:, None] & job_ok[:, None]
                      & (cursor[sel][:, None] + offs[None, :] < job_pcount[sel][:, None])
                      & in_range)
        t_prop = rows_packed[torch.clamp(pofs, 0, T - 1)]
        p_valid = prop_valid.reshape(F)
        p_t = torch.clamp(t_prop, 0, T - 1).reshape(F)
        p_req = task_req[p_t]
        p_node = prop_node_mp.reshape(F).int()
        p_job = sel[:, None].expand(M, P).reshape(F)
        rank = torch.arange(F, device=dev)

        # ---- the accept against the records of the proposals' cells
        p_q = jq_c[p_job]
        key_flat = torch.where(p_valid, p_node * Q + p_q, torch.full_like(p_node, N * Q))
        order2 = K._lexsort((rank, key_flat))
        skf = key_flat[order2]
        snp = torch.where(skf < N * Q, torch.div(skf, Q, rounding_mode="floor"),
                          torch.full_like(skf, N))
        sreqp = torch.where(p_valid[order2, None], p_req[order2], zero)
        seg_start = VK._seg_flags(skf)
        relcump = VK._seg_cumsum(sreqp, seg_start)
        start_pos = torch.cummax(torch.where(seg_start, rank, torch.zeros_like(rank)),
                                 dim=0).values
        srec = prop_rec[order2]
        pos_in_seg = rank - start_pos
        accept_sorted = (torch.all(relcump < _f32(srec[:, 5:]) + c.eps, dim=-1)
                         & (srec[:, 3].long() + pos_in_seg < srec[:, 4].long()) & (snp < N))
        win0 = torch.zeros(F, dtype=torch.bool, device=dev)
        win0[order2] = accept_sorted
        win0 &= p_valid
        win_mp = win0.reshape(M, P)
        win_mp &= torch.cumsum((~win_mp).int(), dim=1) == 0
        if gang_pipelined:
            need = torch.clamp_min(c.job_min[sel] - job_occupied[sel] - pipe[sel], 0)
        else:
            need = torch.zeros(M, **i32)
        commit_m = win_mp.int().sum(dim=1) >= need
        win = (win_mp & commit_m[:, None]).reshape(F)
        any_win = bool(win.any())

        # ---- commit: preemptor placements (replicated)
        delta = torch.where(win[:, None], p_req, zero)
        job_tgt = torch.where(win, p_job, torch.full_like(p_job, J))
        ja2 = job_alloc + VK._segment_sum(delta, job_tgt, J + 1)[:J]
        q_tgt = torch.where(win, p_q, torch.full_like(p_q, Q))
        qa2 = queue_alloc + VK._segment_sum(delta, q_tgt, Q + 1)[:Q]
        wins_per_job = VK._segment_count(win, job_tgt, J + 1)[:J]
        pipe = pipe + wins_per_job
        cursor = cursor + wins_per_job
        wt = p_t[win]
        pipe_node[wt] = p_node[win]
        pipe_att[wt] = (att + rank[win]).int()

        # ---- each block: its cells' grants, its victims (the minimal
        # admitted evict-order prefix of each cell covering its grant), its
        # rows, and its partial sums and victim rows
        parts = torch.zeros((L, mask_at + V), **f64)
        for i, b in enumerate(bs):
            local = p_node.long() - b["n0"]
            mine = win & (local >= 0) & (local < nb)
            flat_tgt = torch.where(mine, local * Q + p_q, nb * Q)
            consumed_flat = VK._segment_sum(delta, flat_tgt, nb * Q + 1)[:nb * Q]
            node_tgt = torch.where(mine, local, nb)
            consumed = VK._segment_sum(delta, node_tgt, nb + 1)[:nb]
            placed_cnt = VK._segment_count(mine, node_tgt, nb + 1)[:nb]
            cum_excl = b["cum"] - b["vr"]
            new_vict = b["cand"] & ~K.less_equal(consumed_flat[b["loc"]], cum_excl, c.eps)
            vreq_new = torch.where(new_vict[:, None], req_ev[b["ev"]], zero)
            vict_node = VK._segment_sum(vreq_new, b["node"], nb)
            b["rel"] = b["rel"] + vict_node - consumed
            b["used"] = b["used"] + consumed
            b["tc"] = b["tc"] + placed_cnt
            jb = job_ev[b["ev"]].long()
            pj = torch.zeros((J, R), **f64).index_add_(0, jb, vreq_new.double())
            qb = torch.where(has_q_ev[b["ev"]], rq_ev[b["ev"]], Q).long()
            pq = torch.zeros((Q + 1, R), **f64).index_add_(0, qb, vreq_new.double())[:Q]
            pc = torch.zeros(J, **f64).index_add_(0, jb, new_vict.double())
            row = parts[i]
            row[:J * R] = pj.reshape(-1)
            row[J * R:J * R + Q * R] = pq.reshape(-1)
            row[J * R + Q * R:J * R + Q * R + J] = pc
            row[mask_at - 1] = float(new_vict.sum())
            row[mask_at + b["ev"]] = new_vict.double()
        recv2 = mesh.exchange(parts)

        # ---- round end (replicated): the blocks' sums in block order
        tot = torch.zeros(mask_at, **f64)
        for k in range(S):
            tot = tot + recv2[k, :mask_at]
        evicted = (recv2[:, mask_at:] > 0).any(dim=0)
        live_ev = live_ev & ~evicted
        evict_att = torch.where(evicted, torch.full_like(evict_att, att + F), evict_att)
        job_alloc = ja2 - tot[:J * R].reshape(J, R).float()
        queue_alloc = qa2 - tot[J * R:J * R + Q * R].reshape(Q, R).float()
        job_occupied = job_occupied - tot[J * R + Q * R:mask_at - 1].int()
        n_vict = int(tot[mask_at - 1])
        drop_now = torch.zeros(J, dtype=torch.bool, device=dev)
        if not any_win:
            drop_now[sel] = sel_active
        dropped = dropped | drop_now
        att += F + 1
        att_total += int(win.sum())
        if any_win:
            last_v = n_vict
        any_commit = any_commit or any_win
        round_ += 1
        progressed = any_win or bool(drop_now.any())

    run_live = torch.zeros(V, dtype=torch.bool, device=dev)
    run_live[o_ev] = live_ev
    ea = torch.full((V,), -1, **i32)
    ea[o_ev] = evict_att
    s = VK.VictimState(run_live=run_live, idle=s0.idle, releasing=tuple(b["rel"] for b in bs),
                       used=tuple(b["used"] for b in bs), task_count=tuple(b["tc"] for b in bs),
                       job_alloc=job_alloc, job_occupied=job_occupied, queue_alloc=queue_alloc)
    rec = VK.StormRecords(ea, pipe_node, pipe_att, torch.tensor(att, **i32))
    return VK.RoundsOut(s, pipe, rec, torch.tensor(att_total, **i32),
                        torch.tensor(last_v, **i32), torch.tensor(any_commit, device=dev),
                        cursor, dropped)

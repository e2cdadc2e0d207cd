"""The scheduler's device programs: hand-written CUDA kernels for Hopper,
each with the plain PyTorch version it must agree with.

Counterpart of ``volcano_tpu/scheduler/kernels.py``.  Every public entry
(``water_fill``, ``allocate_solve``, ``allocate_solve_batch``) takes the
same arguments and returns the same tuple as its JAX namesake:

* given CPU tensors it runs the plain PyTorch version (``*_plain``), a
  line-by-line transcription of the JAX function;
* given CUDA tensors it launches the hand-written kernel from
  ``volcano_tpu_torch/csrc`` (built at first use by ``_build``) or raises.
  There is no fallback from one to the other.

The batched solve's kernels run on node blocks (``batch_launch``): the
whole node axis as one block here, S blocks under a mesh
(``parallel/sharded.py``), one code path.

Float rules shared by both versions (the reference is JAX on the CPU,
whose compiler contracts ``a * b + c`` into one fused multiply-add):

* ``_score_nodes`` rounds ``10 - |cpu_frac - mem_frac| * 10`` and
  ``w_least * least + w_balanced * balanced`` once, as fused operations,
  and the batch solve's jitter is added with one more fused operation.
  The plain version emulates them in float64 (``_fma``); the CUDA sources
  call ``__fmaf_rn`` at exactly those places and are compiled with
  ``--fmad=false`` so that no other product is contracted.
* Sums of resource requests are taken in index order, never with float
  atomics.  Per-node and per-job sums are exact in float32 (whole
  millicores and bytes, far below 2**24 ulps), so any order gives the same
  bits; per-queue sums at cluster scale are not, and both versions add
  them one after the other in index order.  Where such a sum is inexact
  (K1's live weights and deltas on fractional shares), XLA on the CPU
  reduces in an order of its own, and the reference's shares can differ
  from the port's (ROADMAP section 3).

The ``portsel`` extension (host ports and pod (anti)affinity, the dynamic
solve) takes its bitsets PACKED: ``(node_ports [N, 4], task_ports [T, 4],
node_selcnt [N, 64], task_aff [T, 2], task_anti [T, 2], task_self [T, 2],
w_podaff)`` with the u32 words carried as int32 (bit-identical) and the
resident selector counts as int32.  The JAX kernels take the same tuple
unpacked (bool port bits, f32 selector vectors).  The interpod score term
``score + w_podaff * dot`` is one fused multiply-add on the reference too;
``dot`` is a sum of small integers, exact in float32 in any order.

The ``volsel`` extension (volumes, K6, exact solve only) also arrives
packed: ``(task_volmask [T, VW], task_claims [T, 2], claim_group [CL],
group_cap [G, N], group_global [G])`` — each task's feasible-node bitset
words (bit n % 32 of word n // 32), its claims as a 64-bit set (at most
``CLAIM_CAP`` claims), each claim's capacity group, the per-(group, node)
count of Available PVs, and whether a group's pool is global (network
PVs: an assumption decrements the whole row) or node-pinned (only the
taken node's column).  u32 words travel as int32.  ``pack_volsel`` packs
the JAX package's form (``volsolve.VolumePartition.payload``: the claims
as a [T, CL] bool matrix).  A solve with volsel returns ``VolSolveOut``:
``SolveOut`` plus the final ``claim_node`` [CL] (-1: unassumed) and
``vol_cap`` [G, N]; the inputs are not modified.

Tie-breaks are part of the contract: every argmax/argmin takes the lowest
index among equals, and the batch solve's top-K follows ``lax.top_k``
(values descending, lower index first among equals).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from volcano_tpu_torch import vtprof

NEG_INF = float("-inf")
POS_INF = float("inf")

#: the jitter scale of the batch solve, rounded to float32 as JAX rounds it
_JSCALE = float(np.float32(1e-4 / 65535.0))

#: water-fill rounds after which both versions raise instead of looping on
#: (the reference loop has no cap; it stops after at most one round per
#: queue plus one on any realistic input, and would spin forever on an
#: input whose remainder no round can shrink)
WATER_FILL_MAX_ROUNDS = 4096

#: kernel launches since the last ``reset_launches()``; each CUDA wrapper
#: adds one where it launches its kernel, and nowhere else
LAUNCHES: Dict[str, int] = {
    "water_fill": 0,
    "allocate_solve": 0,
    "allocate_solve_batch": 0,
    # K5: launches of K2 / K3 that carried the portsel extension (each also
    # counts under its solve's own name)
    "allocate_solve_portsel": 0,
    "allocate_solve_batch_portsel": 0,
    # K6: launches of K2 that carried the volsel extension
    "allocate_solve_volsel": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch_key(*xs, **kw) -> tuple:
    """A launch's key in vtprof's launch-shape registry: the shapes of the
    tensor arguments (of each tensor inside a tuple, named tuple or dict)
    and the static keyword options; other positional values (a job row, a score
    weight) vary per call and are no part of a shape."""
    def shape(x):
        if torch.is_tensor(x):
            return tuple(x.shape)
        if isinstance(x, dict):
            return tuple(sorted((k, shape(v)) for k, v in x.items()))
        if isinstance(x, (tuple, list)):
            return tuple(shape(v) if torch.is_tensor(v) or isinstance(v, (tuple, list))
                         else v if isinstance(v, (bool, str)) else None for v in x)
        return None

    def static(v):
        if torch.is_tensor(v) or isinstance(v, (tuple, list)):
            return shape(v)
        return v if isinstance(v, (bool, int, float, str)) or v is None else type(v).__name__

    return tuple(shape(x) for x in xs) + tuple(sorted((k, static(v)) for k, v in kw.items()))


# --------------------------------------------------------------------------
# epsilon-tolerant resource comparisons on dense [.., R] vectors
# --------------------------------------------------------------------------

def less_equal(a, b, eps):
    """all_r(a < b + eps) — reference Resource.LessEqual on dense dims."""
    return torch.all(a < b + eps, dim=-1)


def is_empty(a, eps):
    return torch.all(a < eps, dim=-1)


def safe_share(alloc, denom):
    """elementwise l/r with 0/0 = 0 and x/0 = 1 (reference helpers.Share)."""
    zero_denom = denom == 0
    one = torch.ones((), dtype=alloc.dtype, device=alloc.device)
    return torch.where(
        zero_denom,
        torch.where(alloc == 0, torch.zeros_like(one), one),
        alloc / torch.where(zero_denom, one, denom),
    )


def dominant_share(alloc, denom):
    return torch.amax(safe_share(alloc, denom), dim=-1)


def _f32(x) -> float:
    return float(np.float32(float(x)))


def _fma(a, b, c):
    """round_f32(a * b + c) with a single rounding (up to double rounding in
    float64, which needs a tie at float32 precision to show)."""
    def d(x):
        return x.double() if torch.is_tensor(x) else x
    return (d(a) * d(b) + d(c)).float()


#: the width of XLA's summing windows
SUM_WINDOW = 32


def _seq_sum0(x):
    """Sum over axis 0 in index order, from 0.0."""
    acc = torch.zeros_like(x[0])
    for i in range(x.shape[0]):
        acc = acc + x[i]
    return acc


def window_sum0(x):
    """Sum over axis 0 in XLA's order for a float32 axis longer than 32.

    XLA's CPU backend rewrites such a sum as a ``reduce-window`` of size 32
    and stride 32 followed by a ``reduce`` (the HLO of
    ``jax.jit(jnp.sum).lower(x).compile()`` under JAX 0.9.0): pad the axis
    with zeros to a multiple of 32, ``floor(pad / 2)`` in front and the rest
    behind; sum each window of 32 in index order from 0.0; repeat on the
    partials until 32 or fewer remain, then sum those in index order.  An
    axis of 32 or fewer is summed in index order, which is the same rule.
    Equal bit for bit to ``jax.jit(jnp.sum)`` (tests/test_torch_kernels.py);
    ``csrc/water_fill.cu`` sums in the same order.
    """
    while x.shape[0] > SUM_WINDOW:
        n = x.shape[0]
        nw = -(-n // SUM_WINDOW)
        pad = nw * SUM_WINDOW - n
        front = x.new_zeros((pad // 2,) + tuple(x.shape[1:]))
        back = x.new_zeros((pad - pad // 2,) + tuple(x.shape[1:]))
        w = torch.cat([front, x, back]).reshape((nw, SUM_WINDOW) + tuple(x.shape[1:]))
        x = _seq_sum0(w.transpose(0, 1))
    return _seq_sum0(x)


def _score_nodes(req, used, cap, class_score_row, w_least, w_balanced):
    """NodeOrderFn as vector math: [R] -> [N] scores, [M, R] -> [M, N]."""
    used_after = used + req[..., None, :]
    cap_cpu, cap_mem = cap[:, 0], cap[:, 1]
    zero = torch.zeros((), dtype=used.dtype, device=used.device)
    free_cpu = torch.maximum(cap_cpu - used_after[..., 0], zero)
    free_mem = torch.maximum(cap_mem - used_after[..., 1], zero)
    least = (
        torch.where(cap_cpu > 0, free_cpu * 10.0 / torch.clamp_min(cap_cpu, 1e-30), zero)
        + torch.where(cap_mem > 0, free_mem * 10.0 / torch.clamp_min(cap_mem, 1e-30), zero)
    ) * 0.5
    cpu_frac = safe_share(used_after[..., 0], cap_cpu)
    mem_frac = safe_share(used_after[..., 1], cap_mem)
    balanced = torch.where(
        (cap_cpu > 0) & (cap_mem > 0) & (cpu_frac < 1.0) & (mem_frac < 1.0),
        _fma(-torch.abs(cpu_frac - mem_frac), 10.0, 10.0),
        zero,
    )
    return _fma(_f32(w_least), least, balanced * _f32(w_balanced)) + class_score_row


def _jitter_bits(jobs, N, n0=0):
    """[M, N] float32 of the per-(job, node) u32 hash's low 16 bits, for the
    node rows n0 .. n0 + N - 1."""
    mask = 0xFFFFFFFF
    jh = (jobs.long() * 2654435761) & mask
    nh = ((torch.arange(N, device=jobs.device, dtype=torch.int64) + n0) * 40503) & mask
    h = ((jh[:, None] ^ nh[None, :]) * 2246822519) & mask
    h = h ^ (h >> 15)
    return (h & 0xFFFF).float()


def _lexsort(keys):
    """Indices sorting by ``keys`` (last key most significant), stable."""
    idx = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        idx = idx[torch.sort(k[idx], stable=True).indices]
    return idx


def _first_true(mask) -> int:
    return int(torch.argmax(mask.to(torch.int8)))


# --------------------------------------------------------------------------
# K1: proportion water-filling
# --------------------------------------------------------------------------

def water_fill_plain(weight, request, total, eps, participates):
    """Iterative weighted fair share: returns deserved [Q, R]."""
    Q, R = request.shape
    deserved = torch.zeros_like(request)
    met = torch.zeros(Q, dtype=torch.bool, device=request.device)
    remaining = total.clone()
    zero = torch.zeros((), dtype=request.dtype, device=request.device)
    for _ in range(WATER_FILL_MAX_ROUNDS):
        live = participates & ~met
        total_weight = window_sum0(torch.where(live, weight, zero))
        frac = torch.where(
            total_weight > 0, weight / torch.clamp_min(total_weight, 1e-30), zero
        )
        grant = torch.where(live[:, None], remaining[None, :] * frac[:, None], zero)
        new_deserved = deserved + grant
        exceeded = ~less_equal(new_deserved, request, eps) & live
        capped = torch.where(
            exceeded[:, None], torch.minimum(new_deserved, request), new_deserved
        )
        met = met | exceeded
        remaining = remaining - window_sum0(capped - deserved)
        deserved = capped
        if not (bool(total_weight > 0) and not bool(is_empty(remaining, eps))):
            return deserved
    raise RuntimeError(f"water_fill: no convergence in {WATER_FILL_MAX_ROUNDS} rounds")


# --------------------------------------------------------------------------
# K5: the portsel bitsets, unpacked for the plain versions
# --------------------------------------------------------------------------

#: u32 words of the packed bitsets: 128 host-port bits, 64 selector bits
PORT_WORDS = 4
SEL_WORDS = 2


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """[n, W * 32] bool -> [n, W] u32 bitset words, column 32 w + b at bit b
    of word w; ``unpack_bits`` inverts it."""
    n, nbits = bits.shape
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    cols = bits.reshape(n, nbits // 32, 32).astype(np.uint64)
    return (cols * weights).sum(axis=2).astype(np.uint32)


def unpack_bits(words) -> torch.Tensor:
    """[n, W] bitset words -> [n, W * 32] bool, bit b of word w at column
    32 w + b.  ``words``: a tensor of the words' int32 bit patterns, or a
    numpy array of u32 or int32 words."""
    if isinstance(words, np.ndarray):
        words = torch.from_numpy(np.ascontiguousarray(words).view(np.int32))
    n, W = words.shape
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    return (((words.long()[:, :, None] >> shifts) & 1) != 0).reshape(n, W * 32)


class _Portsel(NamedTuple):
    node_ports: torch.Tensor   # [N, 128] bool
    task_ports: torch.Tensor   # [T, 128] bool
    node_selcnt: torch.Tensor  # [N, 64] f32 resident match counts
    task_aff: torch.Tensor     # [T, 64] f32 0/1 required selectors
    task_anti: torch.Tensor    # [T, 64] f32 0/1 anti selectors
    task_self: torch.Tensor    # [T, 64] f32 0/1 selectors the pod's labels match
    w_podaff: float


def _unpack_portsel(portsel) -> _Portsel:
    node_ports_w, task_ports_w, node_selcnt, aff_w, anti_w, self_w, w = portsel
    return _Portsel(
        unpack_bits(node_ports_w), unpack_bits(task_ports_w),
        node_selcnt.float(), unpack_bits(aff_w).float(),
        unpack_bits(anti_w).float(), unpack_bits(self_w).float(), _f32(w),
    )


# --------------------------------------------------------------------------
# K6: the volsel payload, packed for the solve and unpacked for the plain one
# --------------------------------------------------------------------------

#: most distinct constraining claims one dynamic solve carries (the volume
#: partition interns no more), and the u32 words a task's claim set takes
CLAIM_CAP = 64
CLAIM_WORDS = CLAIM_CAP // 32


def pack_volsel(payload: dict) -> tuple:
    """The solve's packed ``volsel`` tuple (numpy, u32 words as int32) from
    a payload dict in the JAX package's form: ``task_volmask_w`` [T, VW]
    u32, ``task_claims`` [T, CL] bool (CL <= 64), ``claim_group`` [CL] i32,
    ``group_cap`` [G, N] i32, ``group_global`` [G] bool."""
    claims = np.asarray(payload["task_claims"], bool)
    T, CL = claims.shape
    if CL > CLAIM_CAP:
        raise ValueError(f"volsel: {CL} claims, at most {CLAIM_CAP}")
    bits = np.zeros((T, CLAIM_CAP), bool)
    bits[:, :CL] = claims
    return (
        np.ascontiguousarray(payload["task_volmask_w"], np.uint32).view(np.int32),
        pack_bits(bits).view(np.int32),
        np.ascontiguousarray(payload["claim_group"], np.int32),
        np.ascontiguousarray(payload["group_cap"], np.int32),
        np.ascontiguousarray(payload["group_global"], bool),
    )


class _Volsel(NamedTuple):
    task_volmask: torch.Tensor  # [T, VW] int32 words
    claims: torch.Tensor        # [T, CL] bool
    claim_group: torch.Tensor   # [CL] int64
    group_cap: torch.Tensor     # [G, N] int32
    group_global: torch.Tensor  # [G] bool


def _unpack_volsel(volsel) -> _Volsel:
    mask_w, claims_w, claim_group, group_cap, group_global = volsel
    CL = claim_group.shape[0]
    return _Volsel(mask_w, unpack_bits(claims_w)[:, :CL], claim_group.long(),
                   group_cap, group_global)


# --------------------------------------------------------------------------
# K2: exact sequential allocate solve
# --------------------------------------------------------------------------

class SolveOut(NamedTuple):
    task_node: torch.Tensor
    task_kind: torch.Tensor
    task_seq: torch.Tensor
    ready: torch.Tensor
    job_alloc: torch.Tensor
    queue_alloc: torch.Tensor
    idle: torch.Tensor
    releasing: torch.Tensor
    used: torch.Tensor
    dropped: torch.Tensor
    steps: torch.Tensor


#: ``SolveOut`` of a solve with volsel, plus its final volume state:
#: ``claim_node`` [CL] (the node each claim assumed its volume on, or -1) and
#: ``vol_cap`` [G, N] (the Available PVs left per group and node)
VolSolveOut = NamedTuple("VolSolveOut", [(f, torch.Tensor) for f in SolveOut._fields]
                         + [("claim_node", torch.Tensor), ("vol_cap", torch.Tensor)])


def _job_keys(names, job_prio, ready, job_min, job_alloc, total):
    keys = []
    for name in names:
        if name == "priority":
            keys.append(-job_prio.float())
        elif name == "gang":
            keys.append((ready >= job_min).float())
        elif name == "drf":
            keys.append(dominant_share(job_alloc, total[None, :]))
    return keys


def allocate_solve_plain(
    idle, releasing, used, node_alloc, node_max_tasks, task_count, node_valid,
    task_req, task_job, task_class, task_valid,
    job_queue, job_min, job_prio, job_ready_init, job_alloc_init,
    job_schedulable, job_start, job_ntasks,
    queue_alloc_init, queue_deserved,
    class_mask, class_score,
    total, eps,
    w_least, w_balanced,
    job_key_order=("priority", "gang", "drf"),
    use_gang_ready=True, use_proportion=True,
    portsel=None, volsel=None,
):
    """The reference allocate loop, one select or place step at a time;
    ``portsel`` (packed, see the module note) adds the resident-state
    predicates and the interpod score, ``volsel`` (packed) the volume
    predicates and the claims' assumptions."""
    dev = idle.device
    N, R = idle.shape
    T = task_req.shape[0]
    J = job_queue.shape[0]
    Q = queue_alloc_init.shape[0]
    jidx = torch.arange(J, device=dev)
    jq_c = job_queue.clamp(0, Q - 1).long()
    idle, releasing, used = idle.clone(), releasing.clone(), used.clone()
    task_count = task_count.clone()
    job_alloc, ready = job_alloc_init.clone(), job_ready_init.clone()
    queue_alloc = queue_alloc_init.clone()
    cursor = torch.zeros(J, dtype=torch.int32, device=dev)
    dropped = torch.zeros(J, dtype=torch.bool, device=dev)
    queue_dropped = torch.zeros(Q, dtype=torch.bool, device=dev)
    task_node = torch.full((T,), -1, dtype=torch.int32, device=dev)
    task_kind = torch.zeros(T, dtype=torch.int32, device=dev)
    task_seq = torch.full((T,), -1, dtype=torch.int32, device=dev)
    ps = _unpack_portsel(portsel) if portsel is not None else None
    if ps is not None:
        node_ports, node_selcnt = ps.node_ports.clone(), ps.node_selcnt.clone()
    vs = _unpack_volsel(volsel) if volsel is not None else None
    if vs is not None:
        claim_node = torch.full((vs.claim_group.shape[0],), -1, dtype=torch.int32, device=dev)
        vol_cap = vs.group_cap.clone()
        claim_glob = vs.group_global[vs.claim_group]
        nidx = torch.arange(N, device=dev, dtype=torch.int32)
    counter = 0
    cur_job = -1
    while True:
        if cur_job < 0:
            active = (
                job_schedulable & ~dropped & (cursor < job_ntasks)
                & ~queue_dropped[jq_c] & (job_queue >= 0)
            )
            if not bool(active.any()):
                break
            q_has = torch.zeros(Q, dtype=torch.bool, device=dev)
            q_has[jq_c[active]] = True
            if use_proportion:
                q_share = dominant_share(queue_alloc, queue_deserved)
            else:
                q_share = torch.zeros(Q, dtype=torch.float32, device=dev)
            qmin = torch.where(q_has, q_share, POS_INF).min()
            qstar = _first_true((q_share == qmin) & q_has)
            if use_proportion and bool(
                less_equal(queue_deserved[qstar], queue_alloc[qstar], eps)
            ):
                queue_dropped[qstar] = True
                continue
            m = active & (job_queue == qstar)
            keys = _job_keys(job_key_order, job_prio, ready, job_min, job_alloc, total)
            keys.append(jidx.float())
            for k in keys:
                kmin = torch.where(m, k, POS_INF).min()
                m = m & (k == kmin)
            cur_job = _first_true(m)
            continue

        j = cur_job
        t = int(job_start[j]) + int(cursor[j])
        req = task_req[t]
        cls = int(task_class[t])
        fit_idle = less_equal(req[None, :], idle, eps) & node_valid
        fit_rel = less_equal(req[None, :], releasing, eps) & node_valid
        pred = class_mask[cls] & (task_count < node_max_tasks)
        feasible = (fit_idle | fit_rel) & pred
        if ps is not None:
            # host ports disjoint from the residents'; every required
            # selector matched by a resident, no anti selector matched
            matched = node_selcnt > 0.5
            ports_ok = ~torch.any(node_ports & ps.task_ports[t][None, :], dim=1)
            req_ok = torch.all(matched | (ps.task_aff[t][None, :] == 0), dim=1)
            anti_ok = torch.all(~matched | (ps.task_anti[t][None, :] == 0), dim=1)
            feasible = feasible & ports_ok & req_ok & anti_ok
        if vs is not None:
            # the task's feasible-node bits; per claim: an assumed claim
            # admits its node only (pinned pool) or any node (global pool),
            # an unassumed one the nodes whose group has a PV left
            vmask = unpack_bits(vs.task_volmask[t:t + 1])[0, :N]
            mine = torch.nonzero(vs.claims[t]).flatten()
            cn = claim_node[mine]
            claim_ok = torch.where(
                (cn >= 0)[:, None],
                claim_glob[mine][:, None] | (nidx[None, :] == cn[:, None]),
                vol_cap[vs.claim_group[mine]] > 0,
            )
            feasible = feasible & vmask & claim_ok.all(dim=0)
        if not bool(feasible.any()):
            dropped[j] = True
            cur_job = -1
            continue
        score = _score_nodes(req, used, node_alloc, class_score[cls], w_least, w_balanced)
        if ps is not None:
            # interpod affinity: +1 per resident match of a required
            # selector, -1 per anti match, weighted; one rounding
            score = _fma(ps.w_podaff, node_selcnt @ (ps.task_aff[t] - ps.task_anti[t]), score)
        n = int(torch.argmax(torch.where(feasible, score, NEG_INF)))
        use_idle = bool(fit_idle[n])
        if use_idle:
            idle[n] = idle[n] - req
        else:
            releasing[n] = releasing[n] - req
        used[n] = used[n] + req
        task_count[n] += 1
        job_alloc[j] = job_alloc[j] + req
        new_ready = int(ready[j]) + (1 if use_idle else 0)
        ready[j] = new_ready
        now_ready = new_ready >= int(job_min[j]) if use_gang_ready else True
        exhausted = int(cursor[j]) + 1 >= int(job_ntasks[j])
        cursor[j] += 1
        q = int(job_queue[j])
        queue_alloc[q] = queue_alloc[q] + req
        task_node[t] = n
        task_kind[t] = 1 if use_idle else 2
        task_seq[t] = counter
        counter += 1
        cur_job = -1 if (now_ready or exhausted) else j
        if ps is not None:
            # the placed pod is resident now (pipelined ones too)
            node_ports[n] = node_ports[n] | ps.task_ports[t]
            node_selcnt[n] = node_selcnt[n] + ps.task_self[t]
        if vs is not None and use_idle:
            # the first allocation of each claim assumes a volume here (a
            # pipelined placement assumes nothing): the claim pins to n and
            # its group's count drops by the claims newly assumed (a
            # segment sum) — over the whole row for a global pool, at n
            # for a pinned one
            newly = vs.claims[t] & (claim_node < 0)
            cnt = torch.zeros(vol_cap.shape[0], dtype=torch.int32, device=dev)
            cnt.index_add_(0, vs.claim_group, newly.to(torch.int32))
            vol_cap = vol_cap - torch.where(vs.group_global, cnt, 0)[:, None]
            vol_cap[:, n] -= torch.where(vs.group_global, 0, cnt)
            claim_node = torch.where(newly, n, claim_node)
    steps = torch.tensor(counter, dtype=torch.int32, device=dev)
    out = (task_node, task_kind, task_seq, ready, job_alloc, queue_alloc,
           idle, releasing, used, dropped, steps)
    if vs is not None:
        return VolSolveOut(*out, claim_node, vol_cap)
    return SolveOut(*out)


# --------------------------------------------------------------------------
# K3: batched-rounds allocate solve
# --------------------------------------------------------------------------

def allocate_solve_batch_plain(
    idle, releasing, used, node_alloc, node_max_tasks, task_count, node_valid,
    task_req, task_job, task_class, task_valid,
    job_queue, job_min, job_prio, job_ready_init, job_alloc_init,
    job_schedulable, job_start, job_ntasks,
    queue_alloc_init, queue_deserved,
    class_mask, class_score,
    total, eps,
    w_least, w_balanced,
    job_key_order=("priority", "gang", "drf"),
    use_gang_ready=True, use_proportion=True,
    m_chunk=512, p_chunk=16, portsel=None,
):
    """Throughput-mode allocate: rounds of parallel block placement, with
    the exact top-K (``exact_topk=True`` of the JAX function); ``portsel``
    as in ``allocate_solve_plain``."""
    dev = idle.device
    N, R = idle.shape
    T = task_req.shape[0]
    J = job_queue.shape[0]
    Q = queue_alloc_init.shape[0]
    M = min(m_chunk, J)
    P = p_chunk
    K = min(p_chunk, N)
    F = M * P
    i32 = torch.int32
    jidx = torch.arange(J, device=dev)
    jq_c = job_queue.clamp(0, Q - 1).long()
    offs = torch.arange(P, device=dev)
    rank = torch.arange(F, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def pad(x, fill=0):
        return torch.cat([x, torch.full((1,) + x.shape[1:], fill, dtype=x.dtype, device=dev)])

    idle, rel, used = idle.clone(), releasing.clone(), used.clone()
    tc = task_count.clone()
    ja, ready = job_alloc_init.clone(), job_ready_init.clone()
    cursor = torch.zeros(J, dtype=i32, device=dev)
    dropped = torch.zeros(J, dtype=torch.bool, device=dev)
    qa = queue_alloc_init.clone()
    tn = torch.full((T,), -1, dtype=i32, device=dev)
    tk = torch.zeros(T, dtype=i32, device=dev)
    ts = torch.full((T,), -1, dtype=i32, device=dev)
    rnd = 0
    progressed = True
    ps = _unpack_portsel(portsel) if portsel is not None else None
    if ps is not None:
        node_ports, node_selcnt = ps.node_ports.clone(), ps.node_selcnt.clone()

    def active_mask():
        if use_proportion:
            q_ok = ~less_equal(queue_deserved, qa, eps)[jq_c]
        else:
            q_ok = torch.ones(J, dtype=torch.bool, device=dev)
        return job_schedulable & ~dropped & (cursor < job_ntasks) & (job_queue >= 0) & q_ok

    while True:
        active = active_mask()
        if not (progressed and bool(active.any())):
            break
        keys = [jidx.float()]
        keys += list(reversed(_job_keys(job_key_order, job_prio, ready, job_min, ja, total)))
        if use_proportion:
            keys.append(dominant_share(qa, queue_deserved)[jq_c])
        keys.append((~active).to(torch.int8))
        order = _lexsort(keys)
        sel = order[:M]
        sel_active = active[sel]

        head_t = (job_start[sel] + cursor[sel]).clamp(0, T - 1).long()
        head_req = task_req[head_t]
        head_cls = task_class[head_t].long()
        fit_i = torch.all(head_req[:, None, :] < idle[None, :, :] + eps, dim=-1)
        fit_r = torch.all(head_req[:, None, :] < rel[None, :, :] + eps, dim=-1)
        pred = class_mask[head_cls] & (tc < node_max_tasks)[None, :] & node_valid[None, :]
        feasible = (fit_i | fit_r) & pred & sel_active[:, None]
        if ps is not None:
            head_ports = ps.task_ports[head_t]
            head_aff, head_anti = ps.task_aff[head_t], ps.task_anti[head_t]
            matched = (node_selcnt > 0.5).float()
            # [M, N] products of 0/1 and count matrices: exact in float32
            port_overlap = head_ports.float() @ node_ports.float().T
            req_missing = head_aff @ (1.0 - matched).T
            anti_hit = head_anti @ matched.T
            feasible = feasible & (port_overlap == 0) & (req_missing == 0) & (anti_hit == 0)
        score = _score_nodes(head_req, used, node_alloc, class_score[head_cls],
                             w_least, w_balanced)
        if ps is not None:
            score = _fma(ps.w_podaff, (head_aff - head_anti) @ node_selcnt.T, score)
        masked = torch.where(feasible, _fma(_jitter_bits(sel, N), _JSCALE, score), NEG_INF)
        job_ok = feasible.any(dim=1)

        t_prop = job_start[sel][:, None] + cursor[sel][:, None] + offs[None, :]
        prop_valid = (
            sel_active[:, None] & job_ok[:, None]
            & (cursor[sel][:, None] + offs[None, :] < job_ntasks[sel][:, None])
        )
        t_prop_c = t_prop.clamp(0, T - 1).long()
        preq = task_req[t_prop_c]

        # exact top-K: values descending, lower index first among equals
        topk_nodes = torch.sort(masked, dim=1, descending=True, stable=True).indices[:, :K]
        rot = (torch.arange(K, device=dev)[None, :]
               + (torch.arange(M, device=dev) % K)[:, None]) % K
        topk_nodes = torch.gather(topk_nodes, 1, rot)
        topk_feasible = torch.gather(feasible, 1, topk_nodes)
        topk_is_idle = torch.gather(fit_i, 1, topk_nodes) & topk_feasible
        idle_k = idle[topk_nodes]
        req_safe = torch.clamp_min(head_req, 1e-30)[:, None, :]
        cnt = torch.floor((idle_k + eps) / req_safe)
        cnt = torch.where(head_req[:, None, :] > 0, cnt, POS_INF).amin(dim=-1)
        cnt = torch.where(topk_is_idle, torch.clamp_min(cnt, 0.0), zero)
        cnt = torch.where(topk_feasible & ~topk_is_idle, torch.ones_like(cnt), cnt)
        if ps is not None:
            # a head with ports or self-matching anti-affinity places at
            # most one task per node
            spread = head_ports.any(dim=1) | ((head_anti * ps.task_self[head_t]).sum(dim=1) > 0)
            cnt = torch.where(spread[:, None], torch.clamp_max(cnt, 1.0), cnt)
        cum_cnt = torch.cumsum(cnt, dim=1)
        slot = (offs[None, :, None].float() >= cum_cnt[:, None, :]).sum(dim=-1)
        in_range = slot < K
        slot_c = slot.clamp(0, K - 1)
        prop_node_mp = torch.gather(topk_nodes, 1, slot_c)
        prop_idle_mp = torch.gather(topk_is_idle, 1, slot_c)
        prop_valid = prop_valid & in_range

        p_valid = prop_valid.reshape(F)
        p_req = preq.reshape(F, R)
        p_node = prop_node_mp.reshape(F)
        p_is_idle = prop_idle_mp.reshape(F) & p_valid
        p_is_pipe = p_valid & ~p_is_idle
        p_job = sel[:, None].expand(M, P).reshape(F)
        p_t = t_prop_c.reshape(F)

        # capacity-aware acceptance over (node, rank)-sorted proposals
        key_node = torch.where(p_is_idle, p_node, N)
        order2 = torch.sort(key_node, stable=True).indices
        sn = key_node[order2]
        sreq = p_req[order2]
        seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sn[1:] != sn[:-1]])
        cum = torch.cumsum(sreq, dim=0)
        start_pos = torch.cummax(torch.where(seg_start, rank, 0), dim=0).values
        relcum = cum - (cum[start_pos] - sreq[start_pos])
        idle_rows = pad(idle)[sn]
        tc_rows = pad(tc)[sn]
        cap_rows = pad(node_max_tasks, 2**31 - 1)[sn]
        pos_in_seg = rank - start_pos
        accept_sorted = (
            torch.all(relcum < idle_rows + eps, dim=-1)
            & (tc_rows + pos_in_seg < cap_rows) & (sn < N)
        )
        if ps is not None:
            # a proposal's ports must miss, and its anti selectors must not
            # match, those of EVERY earlier proposal in its node's run
            # (rejected ones included): an exclusive segmented OR, taken
            # here as a count of earlier set bits
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

        p_node_c = p_node.clamp(0, N - 1)
        pipe_fits = (
            torch.all(p_req < rel[p_node_c] + eps, dim=-1)
            & (tc[p_node_c] < node_max_tasks[p_node_c])
        )
        if ps is not None:
            # proposals with ports or anti selectors never pipeline: pipe
            # wins skip the conflict scan above
            p_is_pipe = p_is_pipe & ~(p_ports.any(dim=1) | p_anti.any(dim=1))
        pipe_node = torch.where(p_is_pipe & pipe_fits, p_node, N)
        best_rank_pipe = torch.full((N + 1,), F, dtype=torch.int64, device=dev)
        best_rank_pipe.scatter_reduce_(0, pipe_node, rank, reduce="amin")
        win_pipe = (best_rank_pipe[pipe_node] == rank) & p_is_pipe & pipe_fits

        win_mp = (accept_idle | win_pipe).reshape(M, P)
        prefix_ok = torch.cumsum((~win_mp).int(), dim=1) == 0
        win = (win_mp & prefix_ok).reshape(F)
        use_idle = accept_idle & win

        delta = torch.where(win[:, None], p_req, zero)
        node_tgt = torch.where(win, p_node, N)
        idle2 = pad(idle).index_add_(0, torch.where(use_idle, node_tgt, N), -delta)
        rel2 = pad(rel).index_add_(0, torch.where(win & ~use_idle, node_tgt, N), -delta)
        used2 = pad(used).index_add_(0, node_tgt, delta)
        tc2 = pad(tc).index_add_(0, node_tgt, win.to(i32))
        job_tgt = torch.where(win, p_job, J)
        ja2 = pad(ja).index_add_(0, job_tgt, delta)
        ready2 = pad(ready).index_add_(0, job_tgt, use_idle.to(i32))
        cursor2 = pad(cursor).index_add_(0, job_tgt, win.to(i32))
        # queue sums outgrow float32's exact range at scale: add in flat
        # order, one after the other (CUDA's index_add_ would use atomics)
        q_tgt = torch.where(win, jq_c[p_job], Q)
        qa2 = pad(qa).cpu().index_add_(0, q_tgt.cpu(), delta.cpu()).to(dev)
        t_tgt = torch.where(win, p_t, T)
        tn2 = pad(tn)
        tn2[t_tgt] = torch.where(win, p_node, 0).to(i32)
        tk2 = pad(tk)
        tk2[t_tgt] = torch.where(use_idle, 1, 2).to(i32)
        ts2 = pad(ts)
        ts2[t_tgt] = (rnd * F + rank).to(i32)

        if ps is not None:
            # winners' ports join their node (scatter-OR), their labels its
            # selector counts
            win_ports = torch.where(win[:, None], p_ports, False).int()
            node_ports = node_ports | (
                torch.zeros((N + 1, win_ports.shape[1]), dtype=i32, device=dev)
                .index_add_(0, node_tgt, win_ports)[:N] > 0)
            node_selcnt = pad(node_selcnt).index_add_(
                0, node_tgt, torch.where(win[:, None], ps.task_self[p_t], zero))[:N]

        # no win this round: drop the lowest-ranked active job, unwinding
        # its placements if it never reached gang readiness
        any_win = bool(win.any())
        n_active = int(active.sum())
        do_evict = (not any_win) and n_active > 0
        victim = int(order[max(n_active - 1, 0)])
        need_rb = do_evict and use_gang_ready and int(ready[victim]) < int(job_min[victim])
        if do_evict:
            dropped[victim] = True
        idle, rel, used, tc = idle2[:N], rel2[:N], used2[:N], tc2[:N]
        ja, ready, cursor, qa = ja2[:J], ready2[:J], cursor2[:J], qa2[:Q]
        tn, tk, ts = tn2[:T], tk2[:T], ts2[:T]
        if need_rb:
            rb_task = (task_job == victim) & (tk > 0) & task_valid
            rb_req = torch.where(rb_task[:, None], task_req, zero)
            t_node = tn.clamp(0, N - 1).long()
            rb_tgt = torch.where(rb_task, t_node, N)
            idle = pad(idle).index_add_(0, torch.where(rb_task & (tk == 1), rb_tgt, N), rb_req)[:N]
            rel = pad(rel).index_add_(0, torch.where(rb_task & (tk == 2), rb_tgt, N), rb_req)[:N]
            used = pad(used).index_add_(0, rb_tgt, -rb_req)[:N]
            tc = pad(tc).index_add_(0, rb_tgt, -rb_task.to(i32))[:N]
            q_rb = torch.zeros((Q + 1, R), dtype=torch.float32, device=dev).index_add_(
                0, torch.where(rb_task, jq_c[task_job.long()], Q), rb_req)
            qa = qa - q_rb[:Q]
            ja = ja.clone()
            ja[victim] = job_alloc_init[victim]
            ready = ready.clone()
            ready[victim] = job_ready_init[victim]
            cursor = cursor.clone()
            cursor[victim] = 0
            if ps is not None:
                # a rolled-back task's port bits are its own on that node
                # (a shared bit could not have co-placed): clear them
                rb_ports = torch.where(rb_task[:, None], ps.task_ports, False).int()
                node_ports = node_ports & ~(
                    torch.zeros((N + 1, rb_ports.shape[1]), dtype=i32, device=dev)
                    .index_add_(0, rb_tgt, rb_ports)[:N] > 0)
                node_selcnt = pad(node_selcnt).index_add_(
                    0, rb_tgt, -torch.where(rb_task[:, None], ps.task_self, zero))[:N]
            tn = torch.where(rb_task, -1, tn).to(i32)
            tk = torch.where(rb_task, 0, tk).to(i32)
            ts = torch.where(rb_task, -1, ts).to(i32)
        progressed = any_win or do_evict
        rnd += 1
    return SolveOut(
        tn, tk, ts, ready, ja, qa, idle, rel, used, dropped,
        torch.tensor(rnd, dtype=torch.int32, device=dev),
    )


def pack_outputs(out) -> torch.Tensor:
    """The four decision outputs as ONE int32 [3T + J] array, so the host
    fetches once.  The CUDA solves write them straight into that layout:
    their outputs come back as the buffer itself, with no copy; the plain
    versions' separate outputs are concatenated."""
    parts = out[:4]
    storage = parts[0].untyped_storage()
    start = at = parts[0].storage_offset()
    in_layout = True
    for p in parts:
        in_layout &= (p.dtype == torch.int32 and p.dim() == 1 and p.is_contiguous()
                      and p.storage_offset() == at
                      and p.untyped_storage().data_ptr() == storage.data_ptr())
        at += p.numel()
    if in_layout:
        return parts[0].new_empty(0).set_(storage, start, (at - start,))
    return torch.cat([p.to(torch.int32) for p in parts])


# --------------------------------------------------------------------------
# CUDA wrappers
# --------------------------------------------------------------------------

class SolveArgs(ctypes.Structure):
    """Mirror of ``struct VttSolveArgs`` in csrc/common.cuh (field order and
    types must match exactly)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "idle", "releasing", "used", "node_alloc", "node_max_tasks",
        "task_count", "node_valid",
        "task_req", "task_job", "task_class", "task_valid",
        "job_queue", "job_min", "job_prio", "job_ready_init",
        "job_alloc_init", "job_schedulable", "job_start", "job_ntasks",
        "queue_deserved", "class_mask", "class_score", "total", "eps",
        "job_alloc", "cursor", "dropped", "queue_alloc", "queue_dropped",
        "packed", "ctl",
        "job_keys", "job_active", "sel",
        "p_node", "p_t", "p_job", "p_flags", "best_pipe",
        "node_ports", "node_selcnt", "task_ports", "task_aff", "task_anti",
        "task_self", "node_match",
        "task_volmask", "task_claims", "claim_group", "group_global",
        "claim_node", "vol_cap",
        "t_val", "t_idx", "t_any", "send", "recv", "p_rec", "p_key",
        "c_key", "c_job", "c_rank", "c_cnt", "c_max", "x_qstate", "x_split",
    )] + [(name, ctypes.c_int64) for name in (
        "n0", "NB", "S", "TB", "TILE", "W",
        "N", "R", "T", "J", "Q", "C", "M", "P", "K", "F",
        "n_keys", "key0", "key1", "key2",
        "use_gang_ready", "use_proportion", "has_portsel",
        "VW", "CL", "G", "has_volsel", "nC",
        "cluster", "x_ns", "x_nres", "x_qsmem", "x_jl",
    )] + [("w_least", ctypes.c_float), ("w_balanced", ctypes.c_float),
          ("w_podaff", ctypes.c_float)]


_KEY_CODE = {"priority": 1, "gang": 2, "drf": 3}
_MAX_R = 8
#: cluster sizes the exact solve runs on (CTAs of one thread-block cluster)
EXACT_CLUSTERS = (1, 2, 4, 8, 16)
#: bytes of queue state (Q * (2R + 2) words) a CTA of the exact solve keeps
#: in shared memory (csrc VTT_EXACT_QSMEM); past it, each CTA's copy lives
#: in global memory
EXACT_QSMEM_BYTES = 16384


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


#: the most (queue, dim) cells K1's kernel takes: its working cells and
#: queues live in one CTA's shared memory (csrc VTT_WF_MAX_CELLS)
WATER_FILL_MAX_CELLS = 8192
#: round words of a K1 workspace: launches whose round-cap check may be
#: pending at once (a slot is checked before it is taken again)
_WF_SLOTS = 8


class _WaterFillWorkspace:
    """K1's scratch on one device: ``_WF_SLOTS`` device round words, their
    pinned host copies, and an event recorded after each copy.  The
    kernel's working cells live in shared memory, so a launch allocates
    only the ``deserved`` it returns (callers keep it for a cycle)."""

    def __init__(self, dev):
        self.rounds = torch.empty(_WF_SLOTS, dtype=torch.int32, device=dev)
        self.host = torch.zeros(_WF_SLOTS, dtype=torch.int32, pin_memory=True)
        self.host_np = self.host.numpy()
        self.events = [torch.cuda.Event() for _ in range(_WF_SLOTS)]
        self.next = 0


#: K1 workspaces by device; launched under the Scheduler's launch lock,
#: like every kernel workspace
_WF_WORKSPACES: Dict[torch.device, _WaterFillWorkspace] = {}
#: K1 launches whose round word is not checked yet: (workspace, slot)
_WF_PENDING: List[Tuple[_WaterFillWorkspace, int]] = []


def _water_fill_resolve(ws, slot) -> None:
    """Wait for the round word of ``slot`` and raise if its fill stopped at
    the cap (the kernel writes -1 then, the rounds taken otherwise)."""
    _WF_PENDING.remove((ws, slot))
    ws.events[slot].synchronize()
    rounds = int(ws.host_np[slot])
    if rounds < 0:
        raise RuntimeError(f"water_fill: no convergence in {WATER_FILL_MAX_ROUNDS} rounds")
    if rounds == 0:
        raise RuntimeError("water_fill: the kernel wrote no round count")


def water_fill_check() -> None:
    """Raise the round-cap error of every K1 launch not checked yet.

    The wrapper does not wait for its kernel: each consumer of the shares
    (K2 and K3 through ``solve_launch`` / ``batch_launch``, K12a and K13
    through ``batch_launch``, K7 and K12b through their launch wrappers)
    calls this before it returns a decision, after its own launches, so the
    wait is for a copy that stream order has already finished; the
    Scheduler calls it again at the end of every cycle.  CPU tensors never
    pend: the plain version raises at once."""
    while _WF_PENDING:
        _water_fill_resolve(*_WF_PENDING[0])


def water_fill_launch(lib, stream, weight, request, total, eps, participates):
    """Launch csrc/water_fill.cu; returns deserved [Q, R] without waiting.
    The round count lands in a pinned host word of this device's workspace
    (a slot a launch), checked by ``water_fill_check``."""
    dev = request.device
    Q, R = request.shape
    f32 = torch.float32
    _check("weight", weight, f32, (Q,), dev)
    _check("request", request, f32, (Q, R), dev)
    _check("total", total, f32, (R,), dev)
    _check("eps", eps, f32, (R,), dev)
    _check("participates", participates, torch.bool, (Q,), dev)
    if not 1 <= R <= _MAX_R:
        raise ValueError(f"water_fill kernel takes 1 <= R <= {_MAX_R}, got {R}")
    if Q * R > WATER_FILL_MAX_CELLS:
        raise ValueError(f"water_fill kernel takes Q*R <= {WATER_FILL_MAX_CELLS} cells (its "
                         f"shared memory), got {Q}*{R}")
    ws = _WF_WORKSPACES.get(dev)
    if ws is None:
        ws = _WF_WORKSPACES[dev] = _WaterFillWorkspace(dev)
    slot = ws.next
    ws.next = (slot + 1) % _WF_SLOTS
    if (ws, slot) in _WF_PENDING:
        _water_fill_resolve(ws, slot)
    ws.host_np[slot] = 0
    deserved = torch.empty((Q, R), dtype=f32, device=dev)
    err = lib.vtt_water_fill(
        weight.data_ptr(), request.data_ptr(), total.data_ptr(), eps.data_ptr(),
        participates.data_ptr(), Q, R, WATER_FILL_MAX_ROUNDS, deserved.data_ptr(),
        ws.rounds.data_ptr() + 4 * slot, ws.host.data_ptr() + 4 * slot, stream,
    )
    _raise_on(err, "vtt_water_fill")
    ws.events[slot].record(torch.cuda.current_stream(dev))
    _WF_PENDING.append((ws, slot))
    return deserved


def water_fill(weight, request, total, eps, participates):
    """Deserved shares [Q, R].  On the card the round-cap error surfaces at
    the next ``water_fill_check`` (see there), before any decision computed
    from these shares is returned."""
    dev = request.device
    tok = None
    if vtprof.PROFILER is not None:  # disarmed, no launch key is built
        tok = vtprof.launch_begin("water_fill", _launch_key(request), dev)
    if dev.type == "cpu":
        return water_fill_plain(weight, request, total, eps, participates)
    if dev.type != "cuda":
        raise ValueError(f"water_fill: unsupported device {dev}")
    from volcano_tpu_torch import _build

    out = water_fill_launch(_build.load(), _stream(dev), weight, request, total, eps, participates)
    LAUNCHES["water_fill"] += 1
    vtprof.launch_end(tok)
    return out


_SOLVE_ARGS = (
    "idle", "releasing", "used", "node_alloc", "node_max_tasks", "task_count",
    "node_valid", "task_req", "task_job", "task_class", "task_valid",
    "job_queue", "job_min", "job_prio", "job_ready_init", "job_alloc_init",
    "job_schedulable", "job_start", "job_ntasks", "queue_alloc_init",
    "queue_deserved", "class_mask", "class_score", "total", "eps",
)


def solve_launch(lib, stream, batch, a, w_least, w_balanced, job_key_order,
                 use_gang_ready, use_proportion, m_chunk=512, p_chunk=16,
                 portsel=None, volsel=None, cluster=None, split=None):
    """Validate the solve inputs ``a`` (name -> tensor), allocate outputs and
    scratch, and launch csrc/allocate_solve.cu (``batch=False``) or
    csrc/allocate_batch.cu on one node block (``batch=True``, through
    ``batch_launch``), with the K5 extension when ``portsel`` is given and
    the K6 extension (exact solve only) when ``volsel`` is.  Returns a
    ``SolveOut`` (a ``VolSolveOut`` with volsel) whose four decision fields
    are views of one int32 [3T + J] buffer (see ``pack_outputs``).

    The exact solve runs as one cluster of ``cluster`` CTAs (one of
    ``EXACT_CLUSTERS``; None: the largest the card admits at this shape),
    and raises if the card refuses that size.  ``split``, an int64 [32]
    tensor on the card, runs the timed instantiation instead, which writes
    there its stage split and, at index 12, the cluster size it ran on
    (see csrc/allocate_solve.cu)."""
    dev = a["idle"].device
    N, R = a["idle"].shape
    T = a["task_req"].shape[0]
    J = a["job_queue"].shape[0]
    Q = a["queue_alloc_init"].shape[0]
    C = a["class_mask"].shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    spec = {
        "idle": (f32, (N, R)), "releasing": (f32, (N, R)), "used": (f32, (N, R)),
        "node_alloc": (f32, (N, R)), "node_max_tasks": (i32, (N,)),
        "task_count": (i32, (N,)), "node_valid": (b8, (N,)),
        "task_req": (f32, (T, R)), "task_job": (i32, (T,)),
        "task_class": (i32, (T,)), "task_valid": (b8, (T,)),
        "job_queue": (i32, (J,)), "job_min": (i32, (J,)), "job_prio": (i32, (J,)),
        "job_ready_init": (i32, (J,)), "job_alloc_init": (f32, (J, R)),
        "job_schedulable": (b8, (J,)), "job_start": (i32, (J,)),
        "job_ntasks": (i32, (J,)), "queue_alloc_init": (f32, (Q, R)),
        "queue_deserved": (f32, (Q, R)), "class_mask": (b8, (C, N)),
        "class_score": (f32, (C, N)), "total": (f32, (R,)), "eps": (f32, (R,)),
    }
    for name, (dt, shape) in spec.items():
        _check(name, a[name], dt, shape, dev)
    if not 2 <= R <= _MAX_R:
        raise ValueError(f"solve kernels take 2 <= R <= {_MAX_R}, got {R}")
    if batch and (cluster is not None or split is not None):
        raise TypeError("cluster and split are options of the exact solve")
    if cluster is not None and cluster not in EXACT_CLUSTERS:
        raise ValueError(f"cluster {cluster}: the exact solve takes one of {EXACT_CLUSTERS}")
    if split is not None:
        _check("split", split, torch.int64, (32,), dev)
    if not batch and N >= 1 << 30:
        raise ValueError(f"the exact solve takes N < 2**30 nodes, got {N}")
    if len(job_key_order) > 3 or any(k not in _KEY_CODE for k in job_key_order):
        raise ValueError(f"unsupported job_key_order {job_key_order!r}")
    if batch:
        if volsel is not None:
            raise TypeError("the batch kernel takes no volsel: volumes force the exact solve")
        block = {k: a[k] for k in NODE_PLANES}
        repl = {k: v for k, v in a.items() if k not in NODE_PLANES}
        task_words = None
        if portsel is not None:
            node_ports, task_ports, node_selcnt, aff, anti, self_, w_podaff = portsel
            block.update(node_ports=node_ports, node_selcnt=node_selcnt)
            task_words = (task_ports, aff, anti, self_, w_podaff)
        return batch_launch(lib, stream, repl, [(0, block)], 1, lambda send: send,
                            w_least, w_balanced, job_key_order, use_gang_ready,
                            use_proportion, m_chunk, p_chunk, task_words)

    def empty(shape, dt):
        return torch.empty(shape, dtype=dt, device=dev)

    packed = empty((3 * T + J,), i32)
    packed[:T] = -1
    packed[T:2 * T] = 0
    packed[2 * T:3 * T] = -1
    packed[3 * T:] = a["job_ready_init"]
    st = {
        "idle": a["idle"].clone(), "releasing": a["releasing"].clone(),
        "used": a["used"].clone(), "task_count": a["task_count"].clone(),
        "job_alloc": a["job_alloc_init"].clone(),
        "cursor": torch.zeros(J, dtype=i32, device=dev),
        "dropped": torch.zeros(J, dtype=b8, device=dev),
        "queue_alloc": a["queue_alloc_init"].clone(),
        "queue_dropped": torch.zeros(Q, dtype=b8, device=dev),
        "ctl": torch.zeros(16, dtype=i32, device=dev),
    }
    # each CTA's copy of the queue state, where it does not fit in shared
    # memory (any queue count runs)
    if Q * (2 * R + 2) * 4 > EXACT_QSMEM_BYTES:
        st["x_qstate"] = empty((max(EXACT_CLUSTERS) * Q * (R + 2),), i32)
    w_podaff = 0.0
    if portsel is not None:
        node_ports, task_ports, node_selcnt, aff, anti, self_, w_podaff = portsel
        for name, t, shape in (
            ("node_ports", node_ports, (N, PORT_WORDS)),
            ("task_ports", task_ports, (T, PORT_WORDS)),
            ("node_selcnt", node_selcnt, (N, 32 * SEL_WORDS)),
            ("task_aff", aff, (T, SEL_WORDS)), ("task_anti", anti, (T, SEL_WORDS)),
            ("task_self", self_, (T, SEL_WORDS)),
        ):
            _check(name, t, i32, shape, dev)
        # the kernels update the resident state in place: working copies
        st.update({
            "node_ports": node_ports.clone(), "node_selcnt": node_selcnt.clone(),
            "task_ports": task_ports, "task_aff": aff, "task_anti": anti,
            "task_self": self_, "node_match": empty((N, SEL_WORDS), i32),
        })
    VW = CL = G = 0
    if volsel is not None:
        mask_w, claims_w, claim_group, group_cap, group_global = volsel
        VW, CL, G = mask_w.shape[1], claim_group.shape[0], group_cap.shape[0]
        for name, t, dt, shape in (
            ("task_volmask", mask_w, i32, (T, VW)),
            ("task_claims", claims_w, i32, (T, CLAIM_WORDS)),
            ("claim_group", claim_group, i32, (CL,)),
            ("group_cap", group_cap, i32, (G, N)),
            ("group_global", group_global, b8, (G,)),
        ):
            _check(name, t, dt, shape, dev)
        if VW * 32 < N or not 1 <= CL <= CLAIM_CAP or G < 1:
            raise ValueError(f"volsel: {VW} mask words for {N} nodes, {CL} claims "
                             f"(1..{CLAIM_CAP}), {G} groups")
        # claim groups index vol_cap rows: checked here, where a bad one
        # would otherwise read outside it on the card
        if bool(((claim_group < 0) | (claim_group >= G)).any()):
            raise ValueError("volsel: claim_group outside [0, G)")
        # the claim and capacity state change as claims assume volumes:
        # working copies, returned as the solve's final volume state
        st.update({
            "task_volmask": mask_w, "task_claims": claims_w, "claim_group": claim_group,
            "group_global": group_global,
            "claim_node": torch.full((CL,), -1, dtype=i32, device=dev),
            "vol_cap": group_cap.clone(),
        })
    args = SolveArgs()
    for fname, _ in SolveArgs._fields_:
        # working copies first: the kernels update them in place
        src = st.get(fname, a.get(fname))
        if src is not None:
            setattr(args, fname, src.data_ptr())
    args.packed = packed.data_ptr()
    codes = [_KEY_CODE[k] for k in job_key_order] + [0, 0, 0]
    args.N, args.R, args.T, args.J, args.Q, args.C = N, R, T, J, Q, C
    args.n_keys = len(job_key_order)
    args.key0, args.key1, args.key2 = codes[:3]
    args.use_gang_ready = int(bool(use_gang_ready))
    args.use_proportion = int(bool(use_proportion))
    args.has_portsel = int(portsel is not None)
    args.VW, args.CL, args.G = VW, CL, G
    args.has_volsel = int(volsel is not None)
    args.w_least = float(w_least)
    args.w_balanced = float(w_balanced)
    args.w_podaff = float(w_podaff)
    args.cluster = cluster or 0
    if split is not None:
        args.x_split = split.data_ptr()
    _raise_on(lib.vtt_allocate_solve(ctypes.byref(args), stream),
              f"vtt_allocate_solve (cluster {cluster or 'auto'})")
    water_fill_check()  # the shares' round word, copied before this launch
    out = (packed[:T], packed[T:2 * T], packed[2 * T:3 * T], packed[3 * T:],
           st["job_alloc"], st["queue_alloc"], st["idle"], st["releasing"],
           st["used"], st["dropped"], st["ctl"][0])
    if volsel is not None:
        return VolSolveOut(*out, st["claim_node"], st["vol_cap"])
    return SolveOut(*out)


#: node-shaped solve inputs: a node block holds these for its own rows (the
#: class planes as [C, NB]); every other input is replicated
NODE_PLANES = ("idle", "releasing", "used", "node_alloc", "node_max_tasks",
               "task_count", "node_valid", "class_mask", "class_score")
#: node rows a CTA of the batch solve scores in shared memory (32 KB of
#: floats); a block's score pass runs over ceil(NB / BATCH_TILE) tiles
BATCH_TILE = 8192
#: proposals a round of the batch solve sorts in one CTA's shared memory
#: (224 KB of keys, indices and digit counters at this cap): m_chunk *
#: p_chunk may not exceed it
MAX_PROPOSALS = 16384
#: jobs a CTA of the batch solve's select sorts (csrc VTT_SEL_CHUNK)
SEL_CHUNK = 2048


def record_words(R: int) -> int:
    """int32 words of one candidate record of the batch solve: value bits,
    global node row, flags (feasible 1, idle fit 2, the block holds a
    feasible node 4), task count, pod cap, idle [R], releasing [R]."""
    return 5 + 2 * R


def batch_launch(lib, stream, a, blocks, n_blocks, exchange, w_least, w_balanced,
                 job_key_order, use_gang_ready, use_proportion, m_chunk=512, p_chunk=16,
                 task_words=None):
    """K3 (csrc/allocate_batch.cu) on node blocks; with ``n_blocks`` > 1 it
    is K12a's sharded solve.

    ``a``: the replicated inputs (the solve inputs but the node planes, and
    ``queue_deserved``).  ``blocks``: this process's node blocks in row
    order, each ``(n0, planes)`` with ``planes`` the ``NODE_PLANES`` of rows
    ``[n0, n0 + NB)`` (and, with K5, its ``node_ports`` / ``node_selcnt``);
    ``task_words``: K5's task words and weight ``(task_ports, task_aff,
    task_anti, task_self, w_podaff)`` or None.  ``n_blocks``: blocks over
    every process, S = N / NB.  ``exchange(send)`` takes this process's
    records ``[L, M*K*W]`` int32 and returns every block's ``[S, M*K*W]``
    in block order (``send`` itself when every block is local).

    The host runs the round loop: two launches of the library a round
    around the exchange, and one 4-byte read of the go flag.  Returns a
    ``SolveOut`` whose four decision fields are views of one int32
    [3T + J] buffer and whose node planes are this process's rows."""
    dev = a["task_req"].device
    L = len(blocks)
    NB = blocks[0][1]["idle"].shape[0]
    N = NB * n_blocks
    R = a["task_req"].shape[1]
    T = a["task_req"].shape[0]
    J = a["job_queue"].shape[0]
    Q = a["queue_alloc_init"].shape[0]
    C = blocks[0][1]["class_mask"].shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    rspec = {
        "task_req": (f32, (T, R)), "task_job": (i32, (T,)), "task_class": (i32, (T,)),
        "task_valid": (b8, (T,)), "job_queue": (i32, (J,)), "job_min": (i32, (J,)),
        "job_prio": (i32, (J,)), "job_ready_init": (i32, (J,)),
        "job_alloc_init": (f32, (J, R)), "job_schedulable": (b8, (J,)),
        "job_start": (i32, (J,)), "job_ntasks": (i32, (J,)),
        "queue_alloc_init": (f32, (Q, R)), "queue_deserved": (f32, (Q, R)),
        "total": (f32, (R,)), "eps": (f32, (R,)),
    }
    for name, (dt, shape) in rspec.items():
        _check(name, a[name], dt, shape, dev)
    bspec = {
        "idle": (f32, (NB, R)), "releasing": (f32, (NB, R)), "used": (f32, (NB, R)),
        "node_alloc": (f32, (NB, R)), "node_max_tasks": (i32, (NB,)),
        "task_count": (i32, (NB,)), "node_valid": (b8, (NB,)),
        "class_mask": (b8, (C, NB)), "class_score": (f32, (C, NB)),
    }
    if task_words is not None:
        bspec.update(node_ports=(i32, (NB, PORT_WORDS)), node_selcnt=(i32, (NB, 32 * SEL_WORDS)))
        for name, t in zip(("task_ports", "task_aff", "task_anti", "task_self"), task_words):
            _check(name, t, i32, (T, PORT_WORDS if name == "task_ports" else SEL_WORDS), dev)
    for i, (n0, planes) in enumerate(blocks):
        if n0 % NB or not 0 <= n0 < N:
            raise ValueError(f"block {i}: first row {n0} is not a block boundary of {N} rows")
        for name, (dt, shape) in bspec.items():
            _check(f"block {i} {name}", planes[name], dt, shape, dev)
    if not 2 <= R <= _MAX_R:
        raise ValueError(f"solve kernels take 2 <= R <= {_MAX_R}, got {R}")
    if len(job_key_order) > 3 or any(k not in _KEY_CODE for k in job_key_order):
        raise ValueError(f"unsupported job_key_order {job_key_order!r}")
    M, P, K = min(m_chunk, J), p_chunk, min(p_chunk, N)
    F = M * P
    if not 1 <= P <= 32 or F > MAX_PROPOSALS:
        raise ValueError(f"batch kernel takes p_chunk in [1, 32] and m_chunk * p_chunk <= "
                         f"{MAX_PROPOSALS} (the accept sort's shared memory), got {P}, {F}")
    TB = -(-NB // BATCH_TILE)
    W = record_words(R)
    nC = -(-J // SEL_CHUNK)

    def empty(shape, dt):
        return torch.empty(shape, dtype=dt, device=dev)

    packed = empty((3 * T + J,), i32)
    packed[:T] = -1
    packed[T:2 * T] = 0
    packed[2 * T:3 * T] = -1
    packed[3 * T:] = a["job_ready_init"]
    send = empty((L, M * K * W), i32)
    st = {
        "job_alloc": a["job_alloc_init"].clone(),
        "cursor": torch.zeros(J, dtype=i32, device=dev),
        "dropped": torch.zeros(J, dtype=b8, device=dev),
        "queue_alloc": a["queue_alloc_init"].clone(),
        "ctl": torch.zeros(16, dtype=i32, device=dev),
        "job_keys": empty((J, 4), f32), "job_active": empty((J,), b8),
        "sel": empty((M,), i32),
        "c_key": empty((nC * M * 4,), f32), "c_job": empty((nC * M,), i32),
        "c_rank": empty((nC * M,), i32), "c_cnt": empty((nC,), i32),
        "c_max": empty((nC,), i32),
        "p_node": empty((F,), i32), "p_t": empty((F,), i32),
        "p_job": empty((F,), i32), "p_flags": empty((F,), torch.uint8),
        "best_pipe": empty((N + 1,), i32), "p_rec": empty((F,), i32),
        "p_key": empty((F,), torch.int64),
        "t_val": empty((M * TB * K,), f32), "t_idx": empty((M * TB * K,), i32),
        "t_any": empty((M * TB,), torch.uint8),
        "packed": packed, "send": send, "recv": send,
    }
    # queue_alloc_init has no field: the kernels start from its copy
    base_fields = {k: a[k] for k in rspec if k != "queue_alloc_init"}
    base_fields.update(st)
    if task_words is not None:
        base_fields.update(zip(("task_ports", "task_aff", "task_anti", "task_self"),
                               task_words[:4]))
    codes = [_KEY_CODE[k] for k in job_key_order] + [0, 0, 0]
    sizes = dict(
        N=N, R=R, T=T, J=J, Q=Q, C=C, M=M, P=P, K=K, F=F, S=n_blocks, NB=NB, TB=TB,
        TILE=BATCH_TILE, W=W, n_keys=len(job_key_order), key0=codes[0], key1=codes[1],
        key2=codes[2], use_gang_ready=int(bool(use_gang_ready)),
        use_proportion=int(bool(use_proportion)), has_portsel=int(task_words is not None),
        nC=nC,
    )
    base = SolveArgs()
    for name, t in base_fields.items():
        setattr(base, name, t.data_ptr())
    for name, v in sizes.items():
        setattr(base, name, v)
    base.w_least, base.w_balanced = float(w_least), float(w_balanced)
    base.w_podaff = float(task_words[4]) if task_words is not None else 0.0
    work = []
    blk_arr = (SolveArgs * L)()
    for i, (n0, planes) in enumerate(blocks):
        # the kernels update the node state in place: working copies
        w = {k: planes[k].clone() for k in ("idle", "releasing", "used", "task_count")}
        if task_words is not None:
            w.update(node_ports=planes["node_ports"].clone(),
                     node_selcnt=planes["node_selcnt"].clone(),
                     node_match=empty((NB, SEL_WORDS), i32))
        work.append(w)
        blk = SolveArgs.from_buffer_copy(base)
        for k in ("node_alloc", "node_max_tasks", "node_valid", "class_mask", "class_score"):
            setattr(blk, k, planes[k].data_ptr())
        for k, t in w.items():
            setattr(blk, k, t.data_ptr())
        blk.n0 = n0
        blk.send = send[i].data_ptr()
        blk_arr[i] = blk
    _raise_on(lib.vtt_batch_begin(ctypes.byref(base), blk_arr, L, stream), "vtt_batch_begin")
    ctl = st["ctl"]
    while int(ctl[1]) > 0:
        _raise_on(lib.vtt_batch_candidates(ctypes.byref(base), blk_arr, L, stream),
                  "vtt_batch_candidates")
        recv = exchange(send)
        if tuple(recv.shape) != (n_blocks, M * K * W) or recv.dtype != i32:
            raise ValueError(f"exchange returned {tuple(recv.shape)} {recv.dtype}, expected "
                             f"({n_blocks}, {M * K * W}) int32")
        st["recv"] = recv  # kept alive until the launches that read it ran
        base.recv = recv.data_ptr()
        _raise_on(lib.vtt_batch_decide(ctypes.byref(base), blk_arr, L, stream),
                  "vtt_batch_decide")
    water_fill_check()  # the round loop's control reads waited on the stream

    def rows(name):
        return work[0][name] if L == 1 else torch.cat([w[name] for w in work])

    return SolveOut(packed[:T], packed[T:2 * T], packed[2 * T:3 * T], packed[3 * T:],
                    st["job_alloc"], st["queue_alloc"], rows("idle"), rows("releasing"),
                    rows("used"), st["dropped"], ctl[0])


_POLICY_ARGS = ("job_key_order", "use_gang_ready", "use_proportion")


def _solve(batch, args, kwargs, plain):
    names = _SOLVE_ARGS + ("w_least", "w_balanced")
    a = dict(zip(names, args))
    a.update({k: v for k, v in kwargs.items() if k in names})
    opts = {k: v for k, v in kwargs.items() if k not in names}
    if batch and opts.get("volsel") is not None:
        # as in the JAX package: volume state is ordered, so volumes force
        # the exact solve
        raise TypeError("allocate_solve_batch takes no volsel: volumes force the exact solve")
    unknown = set(opts) - set(_POLICY_ARGS + ("portsel",)
                              + (("m_chunk", "p_chunk") if batch else ("volsel",)))
    if unknown:
        raise TypeError(f"unexpected arguments {sorted(unknown)}")
    dev = a["idle"].device
    name = "allocate_solve_batch" if batch else "allocate_solve"
    tok = None
    if vtprof.PROFILER is not None:  # disarmed, no launch key is built
        tok = vtprof.launch_begin(name, _launch_key(*a.values(), **opts), dev)
    if dev.type == "cpu":
        return plain(**a, **opts)
    if dev.type != "cuda":
        raise ValueError(f"allocate solve: unsupported device {dev}")
    from volcano_tpu_torch import _build

    w_least, w_balanced = a.pop("w_least"), a.pop("w_balanced")
    out = solve_launch(
        _build.load(), _stream(dev), batch, a, w_least, w_balanced,
        opts.get("job_key_order", ("priority", "gang", "drf")),
        opts.get("use_gang_ready", True), opts.get("use_proportion", True),
        **({k: opts[k] for k in ("m_chunk", "p_chunk", "portsel", "volsel") if k in opts}),
    )
    LAUNCHES[name] += 1
    if opts.get("portsel") is not None:
        LAUNCHES[name + "_portsel"] += 1
    if opts.get("volsel") is not None:
        LAUNCHES["allocate_solve_volsel"] += 1
    vtprof.launch_end(tok)
    return out


def allocate_solve(*args, **kwargs):
    """Exact sequential allocate solve (JAX ``kernels.allocate_solve``;
    ``portsel=`` and ``volsel=`` packed, see the module note).  Returns a
    ``SolveOut``, or a ``VolSolveOut`` when ``volsel`` is given."""
    return _solve(False, args, kwargs, allocate_solve_plain)


def allocate_solve_batch(*args, **kwargs):
    """Batched-rounds allocate solve (JAX ``kernels.allocate_solve_batch``
    with ``exact_topk=True``; ``portsel=`` packed, see the module note).
    Raises TypeError for ``volsel``: volumes force the exact solve."""
    return _solve(True, args, kwargs, allocate_solve_batch_plain)

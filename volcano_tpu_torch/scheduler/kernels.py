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
  them one after the other in the reference's flat order.

Tie-breaks are part of the contract: every argmax/argmin takes the lowest
index among equals, and the batch solve's top-K follows ``lax.top_k``
(values descending, lower index first among equals).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import numpy as np
import torch

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
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _seq_sum0(x):
    """Sum over axis 0 in index order."""
    acc = torch.zeros_like(x[0])
    for i in range(x.shape[0]):
        acc = acc + x[i]
    return acc


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


def _jitter_bits(jobs, N):
    """[M, N] float32 of the per-(job, node) u32 hash's low 16 bits."""
    mask = 0xFFFFFFFF
    jh = (jobs.long() * 2654435761) & mask
    nh = (torch.arange(N, device=jobs.device, dtype=torch.int64) * 40503) & mask
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
        total_weight = _seq_sum0(torch.where(live, weight, zero))
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
        remaining = remaining - _seq_sum0(capped - deserved)
        deserved = capped
        if not (bool(total_weight > 0) and not bool(is_empty(remaining, eps))):
            return deserved
    raise RuntimeError(f"water_fill: no convergence in {WATER_FILL_MAX_ROUNDS} rounds")


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
):
    """The reference allocate loop, one select or place step at a time."""
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
        if not bool(feasible.any()):
            dropped[j] = True
            cur_job = -1
            continue
        score = _score_nodes(req, used, node_alloc, class_score[cls], w_least, w_balanced)
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
    return SolveOut(
        task_node, task_kind, task_seq, ready, job_alloc, queue_alloc,
        idle, releasing, used, dropped,
        torch.tensor(counter, dtype=torch.int32, device=dev),
    )


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
    m_chunk=512, p_chunk=16,
):
    """Throughput-mode allocate: rounds of parallel block placement, with
    the exact top-K (``exact_topk=True`` of the JAX function)."""
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
        score = _score_nodes(head_req, used, node_alloc, class_score[head_cls],
                             w_least, w_balanced)
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
        accept_idle = torch.zeros(F, dtype=torch.bool, device=dev)
        accept_idle[order2] = accept_sorted

        p_node_c = p_node.clamp(0, N - 1)
        pipe_fits = (
            torch.all(p_req < rel[p_node_c] + eps, dim=-1)
            & (tc[p_node_c] < node_max_tasks[p_node_c])
        )
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
        "job_keys", "job_active", "job_rank", "sel",
        "p_node", "p_t", "p_job", "p_flags", "best_pipe",
    )] + [(name, ctypes.c_int64) for name in (
        "N", "R", "T", "J", "Q", "C", "M", "P", "K", "F",
        "n_keys", "key0", "key1", "key2",
        "use_gang_ready", "use_proportion",
    )] + [("w_least", ctypes.c_float), ("w_balanced", ctypes.c_float)]


_KEY_CODE = {"priority": 1, "gang": 2, "drf": 3}
_MAX_R = 8


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


def water_fill_launch(lib, stream, weight, request, total, eps, participates):
    """Launch csrc/water_fill.cu; returns deserved [Q, R]."""
    dev = request.device
    Q, R = request.shape
    f32 = torch.float32
    _check("weight", weight, f32, (Q,), dev)
    _check("request", request, f32, (Q, R), dev)
    _check("total", total, f32, (R,), dev)
    _check("eps", eps, f32, (R,), dev)
    _check("participates", participates, torch.bool, (Q,), dev)
    if Q * R > 1024:
        raise ValueError(f"water_fill kernel takes Q*R <= 1024, got {Q}*{R}")
    deserved = torch.empty((Q, R), dtype=f32, device=dev)
    rounds = torch.empty((1,), dtype=torch.int32, device=dev)
    err = lib.vtt_water_fill(
        weight.data_ptr(), request.data_ptr(), total.data_ptr(), eps.data_ptr(),
        participates.data_ptr(), Q, R, WATER_FILL_MAX_ROUNDS, deserved.data_ptr(),
        rounds.data_ptr(), stream,
    )
    _raise_on(err, "vtt_water_fill")
    # the kernel writes -1 when it stopped at the cap; reading it waits for
    # the kernel (a 4-byte fetch, once a cycle)
    if int(rounds[0]) < 0:
        raise RuntimeError(f"water_fill: no convergence in {WATER_FILL_MAX_ROUNDS} rounds")
    return deserved


def water_fill(weight, request, total, eps, participates):
    dev = request.device
    if dev.type == "cpu":
        return water_fill_plain(weight, request, total, eps, participates)
    if dev.type != "cuda":
        raise ValueError(f"water_fill: unsupported device {dev}")
    from volcano_tpu_torch import _build

    out = water_fill_launch(_build.load(), _stream(dev), weight, request, total, eps, participates)
    LAUNCHES["water_fill"] += 1
    return out


_SOLVE_ARGS = (
    "idle", "releasing", "used", "node_alloc", "node_max_tasks", "task_count",
    "node_valid", "task_req", "task_job", "task_class", "task_valid",
    "job_queue", "job_min", "job_prio", "job_ready_init", "job_alloc_init",
    "job_schedulable", "job_start", "job_ntasks", "queue_alloc_init",
    "queue_deserved", "class_mask", "class_score", "total", "eps",
)


def solve_launch(lib, stream, batch, a, w_least, w_balanced, job_key_order,
                 use_gang_ready, use_proportion, m_chunk=512, p_chunk=16):
    """Validate the solve inputs ``a`` (name -> tensor), allocate outputs and
    scratch, and launch csrc/allocate_solve.cu (``batch=False``) or
    csrc/allocate_batch.cu (``batch=True``).  Returns a ``SolveOut`` whose
    four decision fields are views of one int32 [3T + J] buffer (see
    ``pack_outputs``)."""
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
    if len(job_key_order) > 3 or any(k not in _KEY_CODE for k in job_key_order):
        raise ValueError(f"unsupported job_key_order {job_key_order!r}")
    M = min(m_chunk, J)
    P = p_chunk
    K = min(p_chunk, N)
    F = M * P
    if batch:
        if not 1 <= P <= 32:
            raise ValueError(f"batch kernel takes p_chunk in [1, 32], got {P}")
        if N * 4 > 160 * 1024 or F > 16384:
            raise ValueError(f"batch kernel takes N <= 40960 and F <= 16384, got {N}, {F}")
    elif Q > 64:
        raise ValueError(f"exact kernel takes Q <= 64 queues, got {Q}")

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
    if batch:
        st.update({
            "job_keys": empty((J, 4), f32), "job_active": empty((J,), b8),
            "job_rank": empty((J,), i32), "sel": empty((M,), i32),
            "p_node": empty((F,), i32), "p_t": empty((F,), i32),
            "p_job": empty((F,), i32), "p_flags": empty((F,), torch.uint8),
            "best_pipe": empty((N + 1,), i32),
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
    args.M, args.P, args.K, args.F = M, P, K, F
    args.n_keys = len(job_key_order)
    args.key0, args.key1, args.key2 = codes[:3]
    args.use_gang_ready = int(bool(use_gang_ready))
    args.use_proportion = int(bool(use_proportion))
    args.w_least = float(w_least)
    args.w_balanced = float(w_balanced)
    fn = lib.vtt_allocate_solve_batch if batch else lib.vtt_allocate_solve
    _raise_on(fn(ctypes.byref(args), stream), fn.__name__)
    return SolveOut(
        packed[:T], packed[T:2 * T], packed[2 * T:3 * T], packed[3 * T:],
        st["job_alloc"], st["queue_alloc"], st["idle"], st["releasing"],
        st["used"], st["dropped"], st["ctl"][0],
    )


_POLICY_ARGS = ("job_key_order", "use_gang_ready", "use_proportion")


def _solve(batch, args, kwargs, plain):
    names = _SOLVE_ARGS + ("w_least", "w_balanced")
    a = dict(zip(names, args))
    a.update({k: v for k, v in kwargs.items() if k in names})
    opts = {k: v for k, v in kwargs.items() if k not in names}
    unknown = set(opts) - set(_POLICY_ARGS + (("m_chunk", "p_chunk") if batch else ()))
    if unknown:
        raise TypeError(f"unexpected arguments {sorted(unknown)}")
    dev = a["idle"].device
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
        **({k: opts[k] for k in ("m_chunk", "p_chunk") if k in opts}),
    )
    LAUNCHES["allocate_solve_batch" if batch else "allocate_solve"] += 1
    return out


def allocate_solve(*args, **kwargs):
    """Exact sequential allocate solve (JAX ``kernels.allocate_solve`` with
    ``portsel=None, volsel=None``).  Returns a ``SolveOut``."""
    return _solve(False, args, kwargs, allocate_solve_plain)


def allocate_solve_batch(*args, **kwargs):
    """Batched-rounds allocate solve (JAX ``kernels.allocate_solve_batch``
    with ``portsel=None, exact_topk=True``)."""
    return _solve(True, args, kwargs, allocate_solve_batch_plain)

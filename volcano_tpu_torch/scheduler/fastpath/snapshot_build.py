"""Vectorized snapshot build for the fast cycle.

The port's copy of ``build_fast_snapshot`` from
``volcano_tpu/scheduler/fastpath/snapshot_build.py``, express partition
only: the ArrayMirror's row tables become a bucketed ``TensorSnapshot``
with the same semantics as the JAX builder (asserted by
tests/test_torch_cycle.py).  Dynamic-predicate and volume pods never reach
here — the mirror's ``ineligible_reason`` refuses such clusters first.
Everything is host-side numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from volcano_tpu_torch.api.resource import MIN_MEMORY, MIN_MILLI_CPU, MIN_SCALAR
from volcano_tpu_torch.api.types import PodGroupPhase
from volcano_tpu_torch.scheduler.fastpath.mirror import (
    _ALLOCATED_CODES,
    _INT32_MAX,
    _PENDING,
    _READY_CODES,
    _RELEASING,
    ArrayMirror,
)
from volcano_tpu_torch.scheduler.snapshot import TensorSnapshot, _bucket


def _task_arrays(m: ArrayMirror, pe_rows: np.ndarray, pod_j: np.ndarray,
                 n_jobs: int, N: int, R: int, node_rows_arr: np.ndarray,
                 n_live_ct: int, nodeaffinity_weight: float,
                 job_start: np.ndarray, job_ntasks: np.ndarray) -> dict:
    """Task and predicate-class arrays from the sorted pending rows;
    ``job_start``/``job_ntasks`` are written in place."""
    n_tasks = pe_rows.size
    T = _bucket(max(n_tasks, 1))
    task_req = np.zeros((T, R), np.float32)
    task_job = np.zeros((T,), np.int32)
    task_valid = np.zeros((T,), bool)
    if n_tasks:
        task_req[:n_tasks] = m.p_req[pe_rows]
        task_job[:n_tasks] = pod_j[pe_rows]
        task_valid[:n_tasks] = True
        counts = np.bincount(pod_j[pe_rows], minlength=n_jobs)[:n_jobs]
        job_ntasks[:n_jobs] = counts.astype(np.int32)
        starts = np.zeros(n_jobs, np.int64)
        if n_jobs > 1:
            np.cumsum(counts[:-1], out=starts[1:])
        job_start[:n_jobs] = starts.astype(np.int32)

    # predicate classes: mirror class ids -> snapshot indices in
    # first-appearance order over the sorted task rows
    task_class = np.zeros((T,), np.int32)
    if n_tasks:
        g_cls = m.p_class[pe_rows].astype(np.int64)
        uniq, first_idx = np.unique(g_cls, return_index=True)
        order = np.argsort(first_idx, kind="stable")
        lut = np.empty(uniq.size, np.int32)
        lut[order] = np.arange(uniq.size, dtype=np.int32)
        task_class[:n_tasks] = lut[np.searchsorted(uniq, g_cls)]
        cids_in_order = uniq[order]
    else:
        cids_in_order = np.zeros(0, np.int64)
    C = _bucket(max(cids_in_order.size, 1), minimum=4)
    class_mask = np.zeros((C, N), bool)
    class_score = np.zeros((C, N), np.float32)
    if cids_in_order.size and n_live_ct:
        m.fill_class_cells(cids_in_order, node_rows_arr, nodeaffinity_weight)
        sel = np.ix_(cids_in_order, node_rows_arr)
        nC = cids_in_order.size
        class_mask[:nC, :n_live_ct] = m.cls_mask[sel]
        class_score[:nC, :n_live_ct] = m.cls_score[sel]
    else:
        class_mask[:, :n_live_ct] = True
    return {
        "n_tasks": n_tasks, "task_req": task_req, "task_job": task_job,
        "task_class": task_class, "task_valid": task_valid,
        "class_mask": class_mask, "class_score": class_score,
        "pod_keys": [m.pods.row_key[r] for r in pe_rows],
    }


def build_fast_snapshot(
    m: ArrayMirror, nodeaffinity_weight: float = 1.0,
) -> Tuple[Optional[TensorSnapshot], dict]:
    """(snapshot, aux) from the mirror; aux carries the row <-> key maps the
    publish step needs.  The snapshot is None when no queue exists."""
    R = len(m.dims)
    eps = np.array([MIN_MILLI_CPU, MIN_MEMORY] + [MIN_SCALAR] * (R - 2), np.float32)

    # -- queues (sorted by name)
    q_names = sorted(m.queues.key_row)
    if not q_names:
        return None, {}
    q_idx_of_row = np.full(len(m.q_live), -1, np.int32)
    for i, name in enumerate(q_names):
        q_idx_of_row[m.queues.key_row[name]] = i
    Q = _bucket(len(q_names), minimum=4)
    queue_weight = np.zeros((Q,), np.float32)
    queue_valid = np.zeros((Q,), bool)
    for i, name in enumerate(q_names):
        queue_weight[i] = m.q_weight[m.queues.key_row[name]]
        queue_valid[i] = True

    # -- nodes (arrival order)
    node_rows_arr = np.fromiter(m.nodes.key_row.values(), np.int64, len(m.nodes.key_row))
    n_live_ct = node_rows_arr.size
    N = _bucket(max(n_live_ct, 1))
    n_idx_of_row = np.full(len(m.n_live), -1, np.int32)
    n_idx_of_row[node_rows_arr] = np.arange(n_live_ct, dtype=np.int32)
    node_alloc = np.zeros((N, R), np.float32)
    node_max_tasks = np.full((N,), _INT32_MAX, np.int32)
    node_valid = np.zeros((N,), bool)
    if n_live_ct:
        node_alloc[:n_live_ct] = m.n_alloc[node_rows_arr]
        node_max_tasks[:n_live_ct] = m.n_max_tasks[node_rows_arr]
        node_valid[:n_live_ct] = True

    # -- jobs (sorted by PodGroup resource version); real jobs whose queue
    # is missing are dropped with their pods, shadow gangs stay
    job_rows = np.nonzero(m.j_live)[0]
    if job_rows.size:
        jq = m.j_queue[job_rows]
        job_q_idx = np.where(jq >= 0, q_idx_of_row[np.clip(jq, 0, None)], -1)
    else:
        job_q_idx = np.zeros(0, np.int32)
    kept = (job_q_idx >= 0) | m.j_shadow[job_rows]
    job_rows, job_q_idx = job_rows[kept], job_q_idx[kept]
    order = np.argsort(m.j_rv[job_rows], kind="stable")
    job_rows, job_q_idx = job_rows[order], job_q_idx[order]
    n_jobs = job_rows.size
    J = _bucket(max(n_jobs, 1), minimum=4)
    j_idx_of_row = np.full(len(m.j_live), -1, np.int32)
    j_idx_of_row[job_rows] = np.arange(n_jobs, dtype=np.int32)

    job_queue = np.zeros((J,), np.int32)
    job_min = np.zeros((J,), np.int32)
    job_prio = np.zeros((J,), np.int32)
    job_ready_init = np.zeros((J,), np.int32)
    job_alloc_init = np.zeros((J, R), np.float32)
    job_schedulable = np.zeros((J,), bool)
    job_start = np.zeros((J,), np.int32)
    job_ntasks = np.zeros((J,), np.int32)
    if n_jobs:
        job_queue[:n_jobs] = job_q_idx
        job_min[:n_jobs] = m.j_min[job_rows]
        job_prio[:n_jobs] = m.j_prio[job_rows]
        job_schedulable[:n_jobs] = m.j_phase[job_rows] != m._phase_idx[PodGroupPhase.PENDING]

    # -- pods: usage, shares, pending rows
    P = len(m.p_live)
    live = m.p_live[:P].copy()
    pj = np.where(live, m.p_job[:P], -1)
    pod_j = np.where(pj >= 0, j_idx_of_row[np.clip(pj, 0, None)], -1)
    live &= pod_j >= 0
    codes = m.p_status[:P]

    # node usage: every resident charges used; releasing residents also the
    # releasing pool.  float64 sums of integral values, cast once
    node_used = np.zeros((N, R), np.float32)
    node_rel = np.zeros((N, R), np.float32)
    node_tc = np.zeros((N,), np.int32)
    pn = np.where(live, m.p_node[:P], -1)
    res_rows = np.nonzero(live & (pn >= 0))[0]
    if res_rows.size:
        res_rows = res_rows[m.n_live[pn[res_rows]]]
    res_nodes = n_idx_of_row[pn[res_rows]] if res_rows.size else res_rows
    if res_rows.size:
        ok = res_nodes >= 0
        res_rows, res_nodes = res_rows[ok], res_nodes[ok]
    if res_rows.size:
        used64 = np.zeros((N, R), np.float64)
        np.add.at(used64, res_nodes, m.p_resreq[res_rows])
        node_used[:] = used64.astype(np.float32)
        rel_rows = codes[res_rows] == _RELEASING
        if rel_rows.any():
            rel64 = np.zeros((N, R), np.float64)
            np.add.at(rel64, res_nodes[rel_rows], m.p_resreq[res_rows[rel_rows]])
            node_rel[:] = rel64.astype(np.float32)
        node_tc[:] = np.bincount(res_nodes, minlength=N).astype(np.int32)
    node_idle = np.maximum(node_alloc - node_used, 0.0)

    # shares: allocated statuses charge job/queue alloc and queue request;
    # pending charges queue request
    pend_all = live & (codes == _PENDING)
    queue_alloc = np.zeros((Q, R), np.float32)
    queue_request = np.zeros((Q, R), np.float32)
    queue_participates = np.zeros((Q,), bool)
    if n_jobs:
        queue_participates[job_q_idx[job_q_idx >= 0]] = True
    charge = live & np.isin(codes, _ALLOCATED_CODES)
    ch_rows = np.nonzero(charge)[0]
    if ch_rows.size:
        ja64 = np.zeros(job_alloc_init.shape, np.float64)
        np.add.at(ja64, pod_j[ch_rows], m.p_resreq[ch_rows])
        job_alloc_init[:] = ja64.astype(np.float32)
    qa64 = np.zeros((Q, R), np.float64)
    qr64 = np.zeros((Q, R), np.float64)
    if ch_rows.size:
        chq = ch_rows[job_queue[pod_j[ch_rows]] >= 0]
        np.add.at(qa64, job_queue[pod_j[chq]], m.p_resreq[chq])
        np.add.at(qr64, job_queue[pod_j[chq]], m.p_resreq[chq])
    pd_rows = np.nonzero(pend_all)[0]
    if pd_rows.size:
        pdq = pd_rows[job_queue[pod_j[pd_rows]] >= 0]
        np.add.at(qr64, job_queue[pod_j[pdq]], m.p_resreq[pdq])
    if ch_rows.size or pd_rows.size:
        queue_alloc[:] = qa64.astype(np.float32)
        queue_request[:] = qr64.astype(np.float32)
    rd_rows = np.nonzero(live & np.isin(codes, _READY_CODES))[0]
    if rd_rows.size:
        job_ready_init[:n_jobs] = np.bincount(
            pod_j[rd_rows], minlength=n_jobs).astype(np.int32)[:n_jobs]

    # pending non-best-effort task rows grouped by job in job order, within
    # a job by (-priority, arrival)
    pe_rows = np.nonzero(pend_all & ~m.p_best_effort[:P])[0]
    if pe_rows.size:
        pe_rows = pe_rows[np.lexsort(
            (m.p_rank[pe_rows], -m.p_prio[pe_rows], pod_j[pe_rows]))]
    ta = _task_arrays(m, pe_rows, pod_j, n_jobs, N, R, node_rows_arr,
                      n_live_ct, nodeaffinity_weight, job_start, job_ntasks)

    snap = TensorSnapshot(
        dims=list(m.dims),
        eps=eps,
        node_names=list(m.nodes.key_row),
        node_idle=node_idle,
        node_releasing=node_rel,
        node_used=node_used,
        node_alloc=node_alloc,
        node_max_tasks=node_max_tasks,
        node_task_count=node_tc,
        node_valid=node_valid,
        task_uids=ta["pod_keys"],
        task_req=ta["task_req"],
        task_job=ta["task_job"],
        task_class=ta["task_class"],
        task_valid=ta["task_valid"],
        job_uids=[m.jobs.row_key[r] for r in job_rows],
        job_queue=job_queue,
        job_min_available=job_min,
        job_priority=job_prio,
        job_creation=np.arange(J, dtype=np.int32),
        job_ready_init=job_ready_init,
        job_alloc_init=job_alloc_init,
        job_schedulable=job_schedulable,
        job_start=job_start,
        job_ntasks=job_ntasks,
        queue_names=q_names,
        queue_weight=queue_weight,
        queue_alloc_init=queue_alloc,
        queue_request=queue_request,
        queue_valid=queue_valid,
        queue_participates=queue_participates,
        class_node_mask=ta["class_mask"],
        class_node_score=ta["class_score"],
        total=node_alloc[node_valid].sum(axis=0).astype(np.float32),
    )
    pend_any_per_job = np.zeros(max(n_jobs, 1), np.int64)
    if pd_rows.size and n_jobs:
        pend_any_per_job[:n_jobs] = np.bincount(pod_j[pd_rows], minlength=n_jobs)[:n_jobs]
    aux = {
        "pe_rows": pe_rows,            # task row -> mirror pod row
        "job_rows": job_rows,          # job index -> mirror job row
        "node_rows": node_rows_arr,    # node index -> mirror node row
        "n_jobs": n_jobs,
        "n_tasks": ta["n_tasks"],
        "n_nodes": n_live_ct,
        "pod_j": pod_j,                # mirror pod row -> job index
        "live": live,
        # a copy: publish flips p_status for its binds, while the PodGroup
        # phases count the pre-publish state
        "codes": codes.copy(),
        "node_used": node_used,
        "pend_any_per_job": pend_any_per_job,
        "shadow_job": m.j_shadow[job_rows],
    }
    return snap, aux

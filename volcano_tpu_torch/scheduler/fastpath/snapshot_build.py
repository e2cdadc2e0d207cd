"""Vectorized snapshot build for the fast cycle.

The port's copy of ``build_fast_snapshot`` and ``build_dyn_solve_inputs``
from ``volcano_tpu/scheduler/fastpath/snapshot_build.py``: the
ArrayMirror's row tables become a bucketed ``TensorSnapshot`` of the
express jobs, with the same semantics as the JAX builder (asserted by
tests/test_torch_cycle.py, tests/test_torch_dynamic.py and
tests/test_torch_volumes.py), plus the dynamic-job partition (host ports,
pod (anti)affinity, volumes: the per-cycle volume verdicts of
``volsolve.py``), the dynamic solve's inputs, and the victim pool of the
contention passes.  Everything is host-side numpy.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np

from volcano_tpu_torch.api.resource import MIN_MEMORY, MIN_MILLI_CPU, MIN_SCALAR
from volcano_tpu_torch.api.types import PodGroupPhase
from volcano_tpu_torch.scheduler.fastpath.mirror import (
    _ALLOCATED_CODES,
    _INT32_MAX,
    _PENDING,
    _READY_CODES,
    _RELEASING,
    _RUNNING,
    ArrayMirror,
)
from volcano_tpu_torch.scheduler.kernels import pack_bits, unpack_bits
from volcano_tpu_torch.scheduler.snapshot import TensorSnapshot, _bucket
from volcano_tpu_torch.scheduler.volsolve import RESIDUE, VolumeCycleIndex, VolumePartition


def _task_arrays(m: ArrayMirror, pe_rows: np.ndarray, pod_j: np.ndarray,
                 n_jobs: int, N: int, R: int, node_rows_arr: np.ndarray,
                 n_live_ct: int, nodeaffinity_weight: float,
                 job_start: np.ndarray, job_ntasks: np.ndarray,
                 min_T: int = 1) -> dict:
    """Task and predicate-class arrays from the sorted pending rows;
    ``job_start``/``job_ntasks`` are written in place.  Called at snapshot
    build and again by the contention passes when they re-pack the task
    arrays (``min_T`` keeps a re-pack at the cycle's task bucket)."""
    n_tasks = pe_rows.size
    T = max(_bucket(max(n_tasks, 1)), min_T)
    task_req = np.zeros((T, R), np.float32)
    task_job = np.zeros((T,), np.int32)
    task_valid = np.zeros((T,), bool)
    job_start[:] = 0
    job_ntasks[:] = 0
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
    dyn_batch: Optional[Tuple[str, int]] = None,
) -> Tuple[Optional[TensorSnapshot], dict]:
    """(snapshot, aux) from the mirror; aux carries the row <-> key maps the
    publish step needs.  The snapshot is None when no queue exists.
    ``dyn_batch``: (solve mode, batch threshold) of the dynamic solve, for
    the batch-wave demotion of volume jobs."""
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

    # volume verdicts, once a cycle and only when claim-referencing pending
    # pods exist (volume-free cycles do no work here): each referenced claim
    # interns to a feasible-node set and capacity group, each pod to
    # express (no constraining claim), device or residue
    vol_dev = vol_res_mask = volume_partition = None
    vol_res_reason: Dict[int, str] = {}
    vol_solve_s = 0.0
    vol_rows = np.nonzero(pend_all & m.p_has_vol[:P])[0]
    if vol_rows.size:
        t0 = time.perf_counter()
        volume_partition = VolumePartition(VolumeCycleIndex(
            m.store, [m.node_objs[r] for r in node_rows_arr], n_live_ct))
        vol_dev = np.zeros(P, bool)
        vol_res_mask = np.zeros(P, bool)
        for r in vol_rows:
            pod = m.vol_pod_objs.get(int(r))
            if pod is None:
                continue
            ns = pod.meta.namespace
            tv = volume_partition.classify_task(int(r), [f"{ns}/{name}" for name in pod.volumes])
            if tv.verdict == "device":
                vol_dev[r] = True
            elif tv.verdict == RESIDUE:
                vol_res_mask[r] = True
                vol_res_reason[int(r)] = tv.reason
        vol_solve_s = time.perf_counter() - t0

    # dynamic-job partition: a job with any pending resident-state pod
    # (host ports, pod (anti)affinity, constraining volumes) leaves the
    # express solve WHOLE.  Its pods all expressible and none best-effort:
    # the device dynamic solve serves it after the express pass
    # (dyn_expr_job); otherwise it is a residue job for the object path
    nJ = max(n_jobs, 1)
    dyn_job = np.zeros(nJ, bool)
    dyn_pod_mask = pend_all & m.p_dynamic[:P]
    if vol_dev is not None:
        dyn_pod_mask = dyn_pod_mask | (pend_all & (vol_dev | vol_res_mask))
    dyn_rows = np.nonzero(dyn_pod_mask)[0]
    if dyn_rows.size and n_jobs:
        dyn_job[np.unique(pod_j[dyn_rows])] = True
    resid_job = np.zeros(nJ, bool)
    residue_reason_job: Dict[int, str] = {}
    if dyn_rows.size and n_jobs:
        nonexpr_row = m.p_dynamic[:P] & ~m.p_dyn_expr[:P]
        if vol_res_mask is not None:
            nonexpr_row = nonexpr_row | vol_res_mask
        nonexpr = dyn_rows[nonexpr_row[dyn_rows]]
        for r in nonexpr:
            residue_reason_job.setdefault(int(pod_j[r]),
                                          vol_res_reason.get(int(r), "intern-overflow"))
        if nonexpr.size:
            resid_job[np.unique(pod_j[nonexpr])] = True
        # a pending best-effort pod of a dynamic job needs a backfill with
        # resident-state predicates, which the dynamic solve does not have
        be_pend = np.nonzero(pend_all & m.p_best_effort[:P])[0]
        if be_pend.size:
            be_j = np.unique(pod_j[be_pend])
            for j in be_j[dyn_job[be_j]]:
                residue_reason_job.setdefault(int(j), "best-effort")
            resid_job[be_j[dyn_job[be_j]]] = True
    if volume_partition is not None:
        # the contention closure: jobs sharing a capacity group with any
        # residue-classed claimant join the residue, transitively
        row_job = {int(r): int(pod_j[r]) for r in vol_rows if 0 <= int(pod_j[r]) < nJ}
        resid_set = set(np.nonzero(resid_job)[0].tolist())
        for j, why in volume_partition.demote_contended_jobs(row_job, resid_set).items():
            resid_job[j] = True
            residue_reason_job.setdefault(j, why)
    dyn_expr_job = dyn_job & ~resid_job
    # batch-wave demotion: volume state forces the dynamic solve onto the
    # exact kernel, so when the dyn-expr wave would take the batched one,
    # the volume-device jobs step aside to the residue and the wave keeps
    # its kernel
    if dyn_batch is not None and vol_dev is not None and dyn_batch[0] != "exact":
        vol_dev_job = np.zeros(nJ, bool)
        vd_rows = np.nonzero(pend_all & vol_dev)[0]
        if vd_rows.size and n_jobs:
            vol_dev_job[np.unique(pod_j[vd_rows])] = True
        cand = vol_dev_job & dyn_expr_job
        if cand.any():
            nbr = np.nonzero(pend_all & ~m.p_best_effort[:P])[0]
            wave = int(dyn_expr_job[pod_j[nbr]].sum()) if nbr.size else 0
            if dyn_batch[0] == "batch" or wave > dyn_batch[1]:
                for j in np.nonzero(cand)[0]:
                    resid_job[j] = True
                    residue_reason_job.setdefault(int(j), "batch-wave")
                dyn_expr_job = dyn_job & ~resid_job
    # job-order safety: a dynamic job outranking an express contender in its
    # queue would be served after it by the express-first partition
    partition_unsafe = False
    if dyn_rows.size and n_jobs:
        contender = np.zeros(nJ, bool)
        nb_rows = np.nonzero(pend_all & ~m.p_best_effort[:P])[0]
        if nb_rows.size:
            contender[np.unique(pod_j[nb_rows])] = True
        dyn_c = dyn_job[:n_jobs] & contender[:n_jobs]
        exp_c = ~dyn_job[:n_jobs] & contender[:n_jobs]
        for q in np.unique(job_q_idx[dyn_c]):
            sel = job_q_idx == q
            dp = m.j_prio[job_rows[sel & dyn_c]]
            ep = m.j_prio[job_rows[sel & exp_c]]
            if dp.size and ep.size and dp.max() > ep.min():
                partition_unsafe = True
                break

    # pending non-best-effort task rows of EXPRESS jobs grouped by job in
    # job order, within a job by (-priority, arrival)
    dyn_of_pod = np.zeros(P, bool)
    if dyn_rows.size:
        dyn_of_pod[pod_j >= 0] = dyn_job[np.clip(pod_j[pod_j >= 0], 0, nJ - 1)]
    pe_rows = np.nonzero(pend_all & ~m.p_best_effort[:P] & ~dyn_of_pod)[0]
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
    # per-job counts for enqueue and the preempt / reclaim prechecks; the
    # pending non-best-effort count includes dynamic jobs
    run_per_job = np.zeros(nJ, np.int64)
    pend_any_per_job = np.zeros(nJ, np.int64)
    pend_nonbe_per_job = np.zeros(nJ, np.int64)
    if n_jobs:
        running_rows = np.nonzero(live & (codes == _RUNNING))[0]
        if running_rows.size:
            run_per_job[:n_jobs] = np.bincount(pod_j[running_rows], minlength=n_jobs)[:n_jobs]
        if pd_rows.size:
            pend_any_per_job[:n_jobs] = np.bincount(pod_j[pd_rows], minlength=n_jobs)[:n_jobs]
        nb_all = np.nonzero(pend_all & ~m.p_best_effort[:P])[0]
        if nb_all.size:
            pend_nonbe_per_job[:n_jobs] = np.bincount(pod_j[nb_all], minlength=n_jobs)[:n_jobs]
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
        "run_per_job": run_per_job,
        "pend_any_per_job": pend_any_per_job,
        "pend_nonbe_per_job": pend_nonbe_per_job,
        "shadow_job": m.j_shadow[job_rows],
        # the dynamic-job partition
        "dyn_job": dyn_job,            # [max(n_jobs, 1)] bool
        "dyn_expr_job": dyn_expr_job,  # served by the device dynamic solve
        "partition_unsafe": partition_unsafe,
        "residue_keys": {m.jobs.row_key[job_rows[j]] for j in np.nonzero(resid_job[:n_jobs])[0]},
        "residue_reasons": {m.jobs.row_key[job_rows[j]]: why
                            for j, why in residue_reason_job.items() if j < n_jobs},
        # pending tasks per residue class: volcano_residue_tasks_total
        "residue_task_counts": _residue_counts(residue_reason_job, pend_any_per_job, n_jobs),
        # the cycle's volume interning: the dyn-solve payload and publish's
        # volume binds read it; None on volume-free cycles
        "volume_partition": volume_partition,
        "vol_solve_s": vol_solve_s,
    }
    return snap, aux


def _residue_counts(residue_reason_job: Dict[int, str], pend_any_per_job: np.ndarray,
                    n_jobs: int) -> Dict[str, int]:
    """Pending-task totals per residue class, this cycle's
    volcano_residue_tasks_total increments."""
    counts: Dict[str, int] = {}
    for j, reason in residue_reason_job.items():
        if j < n_jobs:
            counts[reason] = counts.get(reason, 0) + int(pend_any_per_job[j])
    return counts


def build_victim_pool(m: ArrayMirror, snap: TensorSnapshot, aux: dict) -> None:
    """Fill ``snap.run_*``, the preempt / reclaim victim pool, from the
    mirror: running tasks grouped by node in snapshot order, within a node
    by arrival.  Built only on cycles whose prechecks found possible
    contention work; adds ``aux["run_rows"]`` (pool index -> mirror row)."""
    live, codes, pod_j = aux["live"], aux["codes"], aux["pod_j"]
    R = snap.node_idle.shape[1]
    node_rows_arr = aux["node_rows"]
    n_idx_of_row = np.full(len(m.n_live), -1, np.int32)
    if node_rows_arr.size:
        n_idx_of_row[node_rows_arr] = np.arange(node_rows_arr.size, dtype=np.int32)
    rrows = np.nonzero(live & (codes == _RUNNING))[0]
    rnode = rrows
    if rrows.size:
        rn = m.p_node[rrows]
        ok = rn >= 0
        rrows, rn = rrows[ok], rn[ok]
        if rrows.size:
            ok = m.n_live[rn]
            rrows, rn = rrows[ok], rn[ok]
        rnode = n_idx_of_row[rn] if rrows.size else rn
        if rrows.size:
            ok = rnode >= 0
            rrows, rnode = rrows[ok], rnode[ok]
        if rrows.size:
            order = np.lexsort((m.p_rank[rrows], rnode))
            rrows, rnode = rrows[order], rnode[order]
    nv = rrows.size
    V = _bucket(max(nv, 1))
    run_req = np.zeros((V, R), np.float32)
    run_node = np.zeros((V,), np.int32)
    run_job = np.zeros((V,), np.int32)
    run_prio = np.zeros((V,), np.int32)
    run_rank = np.zeros((V,), np.int32)
    run_evictable = np.zeros((V,), bool)
    run_valid = np.zeros((V,), bool)
    if nv:
        run_req[:nv] = m.p_resreq[rrows]
        run_node[:nv] = rnode
        run_job[:nv] = pod_j[rrows]
        run_prio[:nv] = m.p_prio[rrows]
        # dense rank over the pool by arrival
        run_rank[:nv] = np.argsort(np.argsort(m.p_rank[rrows])).astype(np.int32)
        run_evictable[:nv] = m.p_evictable[rrows]
        run_valid[:nv] = True
    snap.run_uids = [m.pods.row_key[r] for r in rrows]
    snap.run_req, snap.run_node, snap.run_job = run_req, run_node, run_job
    snap.run_prio, snap.run_rank = run_prio, run_rank
    snap.run_evictable, snap.run_valid = run_evictable, run_valid
    aux["run_rows"] = rrows


def build_dyn_solve_inputs(m: ArrayMirror, snap: TensorSnapshot, aux: dict,
                           nodeaffinity_weight: float,
                           task_node, task_kind, be_rows, be_nodes,
                           ready) -> Optional[dict]:
    """The dynamic solve's inputs: the dyn-expr jobs' pending task arrays,
    the node, job and queue state after the express solve and backfill,
    the resident port / selector state — this cycle's express and backfill
    placements folded in — and the volume payload (``volsel``, or None).
    Port and selector payloads stay packed u32 words (selector counts u16).
    None when no dyn-expr job has pending work."""
    n_jobs = aux["n_jobs"]
    nJ = max(n_jobs, 1)
    pod_j = aux["pod_j"]
    P = aux["codes"].shape[0]
    dyn_expr = aux["dyn_expr_job"]
    de_of_pod = (pod_j >= 0) & dyn_expr[np.clip(pod_j, 0, nJ - 1)]
    pend = aux["live"] & (aux["codes"] == _PENDING) & ~m.p_best_effort[:P] & de_of_pod
    rows = np.nonzero(pend)[0]
    if not rows.size:
        return None
    rows = rows[np.lexsort((m.p_rank[rows], -m.p_prio[rows], pod_j[rows]))]
    N, R = snap.node_idle.shape
    J = snap.job_queue.shape[0]
    job_start = np.zeros(J, np.int32)
    job_ntasks = np.zeros(J, np.int32)
    ta = _task_arrays(m, rows, pod_j, n_jobs, N, R, aux["node_rows"],
                      aux["n_nodes"], nodeaffinity_weight, job_start, job_ntasks)
    T = ta["task_req"].shape[0]
    S = 32 * m.SW

    def pad(arr):
        out = np.zeros((T,) + arr.shape[1:], arr.dtype)
        out[: rows.size] = arr
        return out

    # resident port bits and selector match counts per node, plus this
    # cycle's express and backfill placements (their labels can match)
    n_live_ct = aux["n_nodes"]
    node_ports_w = np.zeros((N, m.PW), np.uint32)
    node_selcnt = np.zeros((N, S), np.int32)
    if n_live_ct:
        node_ports_w[:n_live_ct] = pack_bits(m.n_port_cnt[aux["node_rows"]] > 0)
        node_selcnt[:n_live_ct] = m.n_sel_cnt[aux["node_rows"]]
    placed = np.nonzero(task_kind > 0)[0]
    if placed.size:
        pm = m.p_selmatch[aux["pe_rows"][placed]]
        nz = pm.any(axis=1)
        if nz.any():
            np.add.at(node_selcnt, task_node[placed[nz]], unpack_bits(pm[nz]).numpy())
    if be_rows.size:
        bm = m.p_selmatch[be_rows]
        nz = bm.any(axis=1)
        if nz.any():
            np.add.at(node_selcnt, be_nodes[nz], unpack_bits(bm[nz]).numpy())
    node_selcnt = node_selcnt.astype(np.uint16)

    # node, job and queue state at the express solve's end; backfilled
    # best-effort pods take task slots only
    idle2 = snap.node_idle.copy()
    rel2 = snap.node_releasing.copy()
    used2 = snap.node_used.copy()
    tc2 = snap.node_task_count.copy()
    job_alloc2 = snap.job_alloc_init.copy()
    queue_alloc2 = snap.queue_alloc_init.copy()
    if placed.size:
        alloc_rows = placed[task_kind[placed] == 1]
        pipe_rows = placed[task_kind[placed] == 2]
        np.subtract.at(idle2, task_node[alloc_rows], snap.task_req[alloc_rows])
        np.subtract.at(rel2, task_node[pipe_rows], snap.task_req[pipe_rows])
        np.add.at(used2, task_node[placed], snap.task_req[placed])
        np.add.at(tc2, task_node[placed], 1)
        np.add.at(job_alloc2, snap.task_job[placed], snap.task_req[placed])
        np.add.at(queue_alloc2, snap.job_queue[snap.task_job[placed]], snap.task_req[placed])
    if be_rows.size:
        np.add.at(tc2, be_nodes, 1)

    sched_mask = np.zeros(J, bool)
    sched_mask[:n_jobs] = dyn_expr[:n_jobs]
    # the volume payload of the routed tasks; None when none carries device
    # volume state, so port/affinity-only waves keep their volsel-free solve
    vp = aux.get("volume_partition")
    volsel = vp.payload(rows, T, N) if vp is not None else None
    return {
        "rows": rows,
        "volsel": volsel,
        "task_req": ta["task_req"], "task_job": ta["task_job"],
        "task_class": ta["task_class"], "task_valid": ta["task_valid"],
        "class_mask": ta["class_mask"], "class_score": ta["class_score"],
        "job_start": job_start, "job_ntasks": job_ntasks,
        "job_schedulable": snap.job_schedulable & sched_mask,
        "job_ready_init": ready.astype(np.int32),
        "job_alloc_init": job_alloc2,
        "queue_alloc_init": queue_alloc2,
        "node_idle": idle2, "node_releasing": rel2, "node_used": used2,
        "node_task_count": tc2,
        "node_ports_w": node_ports_w, "node_selcnt": node_selcnt,
        "task_ports_w": pad(m.p_ports[rows]), "task_aff_w": pad(m.p_aff_req[rows]),
        "task_anti_w": pad(m.p_aff_anti[rows]), "task_self_w": pad(m.p_selmatch[rows]),
    }


# -- multi-controller host shards -----------------------------------------

def host_plane_shard(args, host: int, n_hosts: int):
    """ONE host's shard of the cycle-argument planes (JAX
    ``host_plane_shard``): task planes by task block, node planes by node
    block, replicated planes whole: the per-host snapshot-build unit of the
    multi-controller cycle (``parallel/multihost.py``), whose lockstep run
    times this call per host as that host's ``build_s``.  Slices are made
    contiguous (``ascontiguousarray``: a row slice already is one, a column
    slice of a [C, N] plane is copied).  A cycle argument with no declared
    placement raises."""
    from volcano_tpu_torch.parallel.multihost import _REPLICATED, _SPECS, host_bounds

    out = {}
    n_nodes = np.shape(args["idle"])[0]
    n_tasks = np.shape(args["task_req"])[0]
    nlo, nhi = host_bounds(n_nodes, n_hosts)[host]
    tlo, thi = host_bounds(n_tasks, n_hosts)[host]
    for name, v in args.items():
        arr = np.asarray(v)
        spec = _SPECS.get(name)
        if spec is None:
            if name not in _REPLICATED:
                raise KeyError(f"cycle arg {name!r} has no declared multihost placement "
                               "(_SPECS/_REPLICATED)")
            out[name] = arr
        elif spec[0] == "hosts":           # task plane, host-blocked
            out[name] = np.ascontiguousarray(arr[tlo:thi])
        elif spec[1] == 1:                 # [C, N]: node axis second
            out[name] = np.ascontiguousarray(arr[:, nlo:nhi])
        else:                              # node plane, axis 0
            out[name] = np.ascontiguousarray(arr[nlo:nhi])
    return out

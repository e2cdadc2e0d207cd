"""Publish + close: the fast cycle's output layer.

The port's cut of ``volcano_tpu/scheduler/fastpath/publish.py``: gang-gated
binds through the cache's synchronous bulk verb, and PodGroup status
writes (phase, counts, the Unschedulable condition with its fit-error
message) with the fingerprint discipline that skips no-op writes.  Left
out: the columnar segment, volume binds and the Unschedulable event.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from volcano_tpu_torch.api.objects import PodGroupCondition, PodGroupStatus
from volcano_tpu_torch.api.types import PodGroupPhase
from volcano_tpu_torch.scheduler.fastpath.mirror import _BOUND, _FAILED, _RUNNING, _SUCCEEDED


def render_fit_error(total_nodes: int, reasons: Dict[str, int]) -> str:
    """The "0/N nodes are available, <count> <reason>, ..." aggregate."""
    parts = sorted(f"{count} {reason}" for reason, count in reasons.items())
    return f"0/{total_nodes} nodes are available, {', '.join(parts)}."


def publish_and_close(fc, m, snap, aux, task_node, task_kind, ready,
                      be_rows, be_nodes, be_per_job) -> List[Tuple[str, str]]:
    n_jobs = aux["n_jobs"]
    J = snap.job_min_available.shape[0]
    jm = snap.job_min_available
    pod_j = aux["pod_j"]

    express = np.nonzero(task_kind == 1)[0]
    express_per_job = np.zeros(J, np.int64)
    if express.size:
        express_per_job += np.bincount(snap.task_job[express], minlength=J)
    ready_final = ready.astype(np.int64) + be_per_job
    gang_ready = ready_final >= jm if fc.gang_on else np.ones(J, bool)

    # -- binds: gang-ready express placements, then backfilled pods
    node_rows = aux["node_rows"]
    names = snap.node_names
    cols = []
    if express.size:
        pub = express[gang_ready[snap.task_job[express]]]
        if pub.size:
            cols.append((aux["pe_rows"][pub], task_node[pub]))
    if be_rows.size:
        keep = gang_ready[pod_j[be_rows]]
        if keep.any():
            cols.append((be_rows[keep], be_nodes[keep]))
    binds: List[Tuple[str, str]] = []
    for prows, nidx in cols:
        m.p_status[prows] = _BOUND
        m.p_node[prows] = node_rows[nidx]
        binds.extend(zip((m.pods.row_key[r] for r in prows.tolist()),
                         (names[n] for n in nidx.tolist())))

    # -- per-job status (framework._update_pod_group_status parity)
    codes, live = aux["codes"], aux["live"]

    def per_job(code):
        rows = np.nonzero(live & (codes == code))[0]
        out = np.zeros(max(n_jobs, 1), np.int64)
        if rows.size and n_jobs:
            out[:n_jobs] = np.bincount(pod_j[rows], minlength=n_jobs)[:n_jobs]
        return out

    running_ct = per_job(_RUNNING)
    failed_ct = per_job(_FAILED)
    succeeded_ct = per_job(_SUCCEEDED)
    nj = max(n_jobs, 1)
    allocated_after = per_job(_BOUND) + running_ct + express_per_job[:nj] + be_per_job[:nj]
    ntasks_per_job = np.zeros(nj, np.int64)
    lrows = np.nonzero(live)[0]
    if lrows.size and n_jobs:
        ntasks_per_job[:n_jobs] = np.bincount(pod_j[lrows], minlength=n_jobs)[:n_jobs]
    unready = (ready_final[:n_jobs] < jm[:n_jobs].astype(np.int64)
               if fc.gang_on else np.zeros(n_jobs, bool))
    shadow_job = aux["shadow_job"]
    fit_msgs = fit_errors(fc, snap, aux, task_node, task_kind,
                          unready & ~shadow_job[: unready.shape[0]])

    phase_idx = m._phase_idx
    inqueue = phase_idx[PodGroupPhase.INQUEUE]
    ops: List[dict] = []
    for j in range(n_jobs):
        if shadow_job[j]:
            continue  # shadow gangs have no PodGroup to write to
        jrow = aux["job_rows"][j]
        pg_key = m.jobs.row_key[jrow]
        unsched = bool(unready[j])
        msg = ""
        if unsched:
            fit = fit_msgs.get(j, "")
            msg = (f"{int(jm[j] - ready_final[j])}/{int(ntasks_per_job[j])} tasks in gang "
                   f"unschedulable" + (f": {fit}" if fit else ""))
        if int(running_ct[j]) and unsched:
            phase = phase_idx[PodGroupPhase.UNKNOWN]
        elif int(allocated_after[j]) > int(jm[j]):
            phase = phase_idx[PodGroupPhase.RUNNING]
        elif int(m.j_phase[jrow]) != inqueue:
            phase = phase_idx[PodGroupPhase.PENDING]
        else:
            phase = inqueue
        fp = (phase, int(running_ct[j]), int(failed_ct[j]), int(succeeded_ct[j]), msg)
        if fc._status_fp.get(pg_key) == fp:
            continue
        conditions = []
        if unsched:
            conditions.append(PodGroupCondition(
                kind="Unschedulable", status="True",
                reason="NotEnoughResources", message=msg))
        status = PodGroupStatus(
            phase=m._phases[phase], conditions=conditions,
            running=int(running_ct[j]), succeeded=int(succeeded_ct[j]),
            failed=int(failed_ct[j]),
        )
        fc._status_fp[pg_key] = fp
        ops.append({"op": "patch", "kind": "PodGroup", "key": pg_key,
                    "fields": {"status": status}})

    fc.cache.bind_bulk(binds)
    if ops:
        for op, err in zip(ops, fc.store.bulk(ops)):
            if err is not None:
                fc.cache._record_err("status", op["key"], RuntimeError(err))
    return binds


def fit_errors(fc, snap, aux, task_node, task_kind, unready) -> Dict[int, str]:
    """Per-dim insufficient-node counts for unready jobs with pending tasks
    (job_info.go:338-373), via sorted idle columns + searchsorted."""
    n_jobs = aux["n_jobs"]
    if not fc.gang_on or not unready.any():
        return {}
    ujobs = np.nonzero(unready & (snap.job_ntasks[:n_jobs] > 0))[0]
    if not ujobs.size:
        return {}
    n_nodes = aux["n_nodes"]
    idle_after = snap.node_idle[:n_nodes].copy()
    placed = np.nonzero(task_kind == 1)[0]
    if placed.size:
        np.subtract.at(idle_after, task_node[placed], snap.task_req[placed])
    total = int(snap.node_valid[:n_nodes].sum())
    heads = snap.job_start[ujobs]
    head_cls = snap.task_class[heads]
    req = snap.task_req[heads]
    R = req.shape[1]
    counts = np.zeros((ujobs.size, R), np.int64)
    excluded = np.zeros(ujobs.size, np.int64)
    for cid in np.unique(head_cls):
        rows = np.nonzero(head_cls == cid)[0]
        mask = snap.class_node_mask[cid][:n_nodes] & snap.node_valid[:n_nodes]
        excluded[rows] = total - int(mask.sum())
        masked = idle_after[mask]
        for r in range(R):
            col = np.sort(masked[:, r])
            counts[rows, r] = np.searchsorted(col, req[rows, r], side="left")
    out = {}
    for u, j in enumerate(ujobs):
        reasons = {}
        if excluded[u]:
            reasons["node(s) excluded by predicates"] = int(excluded[u])
        for r, dim in enumerate(snap.dims):
            if int(counts[u, r]):
                reasons[f"insufficient {dim}"] = int(counts[u, r])
        if reasons:
            out[int(j)] = render_fit_error(total, reasons)
    return out

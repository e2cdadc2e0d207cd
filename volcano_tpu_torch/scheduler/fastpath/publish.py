"""Publish + close: the fast cycle's output layer.

The port's copy of ``volcano_tpu/scheduler/fastpath/publish.py``:
gang-gated binds as columns straight from the solve's arrays (pod keys,
node ids into a table of the nodes they touch), shipped with the
contention passes' evictions as ONE columnar ``DecisionSegment`` through
the async applier (``cache.publish_segment``), or through the cache's
per-object bulk verbs under the synchronous mode; PodGroup status writes (phase, counts, the Unschedulable
condition with its fit-error message) with the fingerprint discipline that
skips no-op writes, an Unschedulable Warning Event on the condition's
transitions only (``fc._last_unsched``), the gang metrics, and the volume
binds of the pods that mount claims (``volume_bind_filter``).  The
statuses go through the applier when there is one.  ``fc.phases`` gets
``publish_build`` (columns, statuses, fit errors) and ``publish_ship``
(the segment or bulk hand-off).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import time

import numpy as np

from volcano_tpu_torch import events
from volcano_tpu_torch.api.objects import Metadata, PodGroupCondition, PodGroupStatus, new_uid
from volcano_tpu_torch.api.types import PodGroupPhase
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.scheduler.cache import VolumeBindingError
from volcano_tpu_torch.scheduler.fastpath.mirror import _BOUND, _FAILED, _RUNNING, _SUCCEEDED
from volcano_tpu_torch.store.segment import DecisionSegment


def render_fit_error(total_nodes: int, reasons: Dict[str, int]) -> str:
    """The "0/N nodes are available, <count> <reason>, ..." aggregate."""
    parts = sorted(f"{count} {reason}" for reason, count in reasons.items())
    return f"0/{total_nodes} nodes are available, {', '.join(parts)}."


def publish_and_close(fc, m, snap, aux, task_node, task_kind, ready,
                      be_rows, be_nodes, be_per_job, pe_rows_solve,
                      task_job_solve, task_req_solve, evicts=(),
                      ready_status=None, write_status=True) -> List[Tuple[str, str]]:
    """``task_node``/``task_kind`` index the solves' merged task layout
    (express rows, then the dynamic solve's); ``pe_rows_solve``,
    ``task_job_solve`` and ``task_req_solve`` are that layout's mirror pod
    rows, jobs and requests.  ``evicts``: (pod_key, reason) victims of the
    contention passes.  ``ready_status``: per-job ready counts at the
    cycle's end for the status section when preempt ran after allocate
    (the bind gate keeps allocate-time readiness).  ``write_status``:
    False on a multi-controller worker (statuses are the coordinator's) and
    when the object sub-cycle writes them."""
    t_build0 = time.perf_counter()
    n_jobs = aux["n_jobs"]
    J = snap.job_min_available.shape[0]
    jm = snap.job_min_available
    pod_j = aux["pod_j"]

    express = np.nonzero(task_kind == 1)[0]
    express_per_job = np.zeros(J, np.int64)
    if express.size:
        express_per_job += np.bincount(task_job_solve[express], minlength=J)
    if fc.mesh_hosts > 1:
        # the owned-slice fetch zero-filled task_kind outside this host's
        # block: the per-job counts come from the ready deltas of the whole
        # [J] plane every host fetched
        express_per_job = np.maximum(
            ready.astype(np.int64) - snap.job_ready_init.astype(np.int64), 0)
    ready_final = ready.astype(np.int64) + be_per_job
    gang_ready = ready_final >= jm if fc.gang_on else np.ones(J, bool)

    # -- binds: gang-ready express placements, then backfilled pods, as
    # columns: mirror rows all the way, the key strings in one sweep, node
    # ids interned into a table of only the nodes they touch
    node_rows = aux["node_rows"]
    names = snap.node_names
    cols = []
    if express.size:
        pub = express[gang_ready[task_job_solve[express]]]
        if pub.size:
            cols.append(volume_bind_filter(fc, m, pe_rows_solve[pub], task_node[pub], names))
    if be_rows.size:
        keep = gang_ready[pod_j[be_rows]]
        if keep.any():
            cols.append(volume_bind_filter(fc, m, be_rows[keep], be_nodes[keep], names))
    for prows, nidx in cols:
        m.p_status[prows] = _BOUND
        m.p_node[prows] = node_rows[nidx]
    cols = [(p, n) for p, n in cols if p.size]
    if cols:
        rows_all = np.concatenate([p for p, _ in cols])
        nidx_all = np.concatenate([n for _, n in cols])
        row_key = m.pods.row_key
        bind_keys = [row_key[r] for r in rows_all.tolist()]
        uniq, inv = np.unique(nidx_all, return_inverse=True)
        bind_table = [names[i] for i in uniq.tolist()]
        bind_nodes = inv.tolist()
    else:
        bind_keys, bind_nodes, bind_table = [], [], []

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
    status_ready = ready_final if ready_status is None else ready_status.astype(np.int64)
    unready = (status_ready[:n_jobs] < jm[:n_jobs].astype(np.int64)
               if fc.gang_on else np.zeros(n_jobs, bool))
    shadow_job = aux["shadow_job"]
    fit_msgs = fit_errors(fc, snap, aux, task_node, task_kind,
                          unready & ~shadow_job[: unready.shape[0]],
                          task_req_solve) if write_status else {}

    phase_idx = m._phase_idx
    inqueue = phase_idx[PodGroupPhase.INQUEUE]
    ops: List[dict] = []
    n_unsched_jobs = 0
    for j in range(n_jobs if write_status else 0):
        if shadow_job[j]:
            continue  # shadow gangs have no PodGroup to write to
        jrow = aux["job_rows"][j]
        pg_key = m.jobs.row_key[jrow]
        unsched = bool(unready[j])
        msg = ""
        if unsched:
            n_unsched_jobs += 1
            unready_n = int(jm[j] - status_ready[j])
            fit = fit_msgs.get(j, "")
            msg = (f"{unready_n}/{int(ntasks_per_job[j])} tasks in gang "
                   f"unschedulable" + (f": {fit}" if fit else ""))
            metrics.update_unschedule_task_count(pg_key, unready_n)
        if int(running_ct[j]) and unsched:
            phase = phase_idx[PodGroupPhase.UNKNOWN]
        elif int(allocated_after[j]) > int(jm[j]):
            phase = phase_idx[PodGroupPhase.RUNNING]
        elif int(m.j_phase[jrow]) != inqueue:
            phase = phase_idx[PodGroupPhase.PENDING]
        else:
            phase = inqueue
        fp = (phase, int(running_ct[j]), int(failed_ct[j]), int(succeeded_ct[j]), msg)
        if fc._status_fp.get(pg_key) == fp and not (
                unsched and fc._last_unsched.get(pg_key) != msg):
            continue
        conditions = []
        if unsched:
            conditions.append(PodGroupCondition(
                kind="Unschedulable", status="True",
                reason="NotEnoughResources", message=msg))
            if fc._last_unsched.get(pg_key) != msg:
                # a Warning Event on condition transitions only (the gang
                # plugin's rule)
                ops.append({"op": "create", "kind": "Event",
                            "object": events.ClusterEvent(
                                meta=Metadata(name=new_uid("event"), namespace=""),
                                involved=("PodGroup", pg_key), reason="Unschedulable",
                                message=msg, type=events.WARNING)})
                fc._last_unsched[pg_key] = msg
                metrics.register_job_retry(pg_key)
        else:
            fc._last_unsched.pop(pg_key, None)
        status = PodGroupStatus(
            phase=m._phases[phase], conditions=conditions,
            running=int(running_ct[j]), succeeded=int(succeeded_ct[j]),
            failed=int(failed_ct[j]),
        )
        fc._status_fp[pg_key] = fp
        ops.append({"op": "patch", "kind": "PodGroup", "key": pg_key,
                    "fields": {"status": status}})
    if write_status:
        metrics.update_unschedule_job_count(n_unsched_jobs)

    # -- ship: the segment (or the per-object bulk ops), then the statuses
    t_ship0 = time.perf_counter()
    fc.phases["publish_build"] = t_ship0 - t_build0
    if fc.cache.applier is not None:
        seg = DecisionSegment.build(bind_keys, bind_nodes, bind_table, list(evicts))
        fc.cache.publish_segment(seg)
        binds = seg.bind_pairs()
    else:
        binds = list(zip(bind_keys, (bind_table[n] for n in bind_nodes)))
        fc.cache.bind_bulk(binds)
        fc.cache.evict_bulk(list(evicts))
    if ops:
        applier = fc.cache.applier
        if applier is not None:
            applier.submit_ops(ops)
        else:
            try:
                results = fc.store.bulk(ops)
            except Exception as e:  # noqa: BLE001 — retried next cycle
                for op in ops:
                    fc.cache._record_err("status", op.get("key", op["kind"]), e)
            else:
                for op, err in zip(ops, results):
                    if err is not None:
                        fc.cache._record_err("status", op.get("key", op["kind"]),
                                             RuntimeError(err))
    fc.phases["publish_ship"] = time.perf_counter() - t_ship0
    return binds


def volume_bind_filter(fc, m, prows, nidx, names):
    """allocate_volumes + bind_volumes for the published binds (mirror rows
    ``prows`` on node indices ``nidx``) of pods that mount claims.  The
    solve already chose the nodes, so this validates and commits: static
    assumptions take their PV and dynamic claims get one provisioned.  A
    concurrent store writer (a PV gone or taken since the solve) raises
    VolumeBindingError: that bind is dropped and recorded, the pod stays
    pending and a later cycle retries.  Returns the kept (rows, nodes);
    volume-free binds pass on one vectorized check."""
    hasv = m.p_has_vol[prows]
    if not hasv.any():
        return prows, nidx
    if not fc._vol_session_cleared:
        # a fresh binder view once a cycle (claims and PVs are cached per
        # session)
        fc.cache.clear_session_volumes()
        fc._vol_session_cleared = True
    keep = np.ones(prows.size, bool)
    for i in np.nonzero(hasv)[0]:
        pod = m.vol_pod_objs.get(int(prows[i]))
        if pod is None or not pod.volumes:
            continue
        try:
            fc.cache.allocate_volumes(pod, names[int(nidx[i])])
            fc.cache.bind_volumes(pod)
        except VolumeBindingError as e:
            fc.cache._record_err("bind_volumes", pod.meta.key, e)
            keep[i] = False
    if keep.all():
        return prows, nidx
    return prows[keep], nidx[keep]


def fit_errors(fc, snap, aux, task_node, task_kind, unready,
               task_req_solve) -> Dict[int, str]:
    """Per-dim insufficient-node counts for unready express jobs with
    pending tasks (job_info.go:338-373), via sorted idle columns +
    searchsorted; the idle left counts every placement of the merged
    layout."""
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
        np.subtract.at(idle_after, task_node[placed], task_req_solve[placed])
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

"""Row-keyed incremental pod aggregates, the snapshot's one patch, and the
``snapshot-incremental`` oracle.

The port's copy of ``volcano_tpu/scheduler/delta/incremental.py``.
:class:`PodAggregates` keeps what ``build_fast_snapshot``'s O(P) pod sweeps
derive (node used, releasing and task counts; job alloc, ready, running
and pending counts; queue alloc and request) as float64 / int64
accumulators keyed by mirror row (node, job, queue row), updated by a
shadow diff of the dirty rows instead of a fresh sweep.

Exact, not approximate: the inputs are integer-valued float32 (milli-CPU,
bytes, device counts), so their float64 sums are exact and independent of
order, and adding and subtracting contributions in event order lands on
the bits of one fresh sweep, which also sums in float64 and casts to
float32 once.  Each row's contribution is recorded in a shadow copy when
it is added, and exactly that is subtracted later, whatever occupies the
row by then.  What row keys cannot express (resync, node add or remove,
PodGroup removal, queue moves) is structural: the engine builds full and
calls :meth:`PodAggregates.rebuild`.

:func:`assert_snapshot_equal` holds a micro build bit for bit to a full
build on the same mirror state.  It compares the snapshot's host arrays
(the arrays the solve uploads) and the aux maps, never device tensors, so
it costs no device sync.  :func:`patch_task_planes` is the one way a delta
module rewrites snapshot columns after the build (admission's filter).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import numpy as np

from volcano_tpu_torch.scheduler.fastpath.mirror import (
    _ALLOCATED_CODES,
    _PENDING,
    _READY_CODES,
    _RELEASING,
    _RUNNING,
    _grow,
)


class PodAggregates:
    """The pod sweeps' aggregates, kept incrementally by mirror row."""

    def __init__(self, R: int) -> None:
        self.R = R
        # by node row
        self.node_used = np.zeros((0, R), np.float64)
        self.node_rel = np.zeros((0, R), np.float64)
        self.node_tc = np.zeros((0,), np.int64)
        # by job row
        self.job_alloc = np.zeros((0, R), np.float64)
        self.job_ready = np.zeros((0,), np.int64)
        self.run_ct = np.zeros((0,), np.int64)
        self.pend_any = np.zeros((0,), np.int64)
        self.pend_nonbe = np.zeros((0,), np.int64)
        # by queue row
        self.q_alloc = np.zeros((0, R), np.float64)
        self.q_request = np.zeros((0, R), np.float64)
        #: live pending job-linked pods with dynamic predicates or volume
        #: claims: non-zero forces the "dynamic" full build (the partition
        #: needs the full classifier)
        self.n_dynvol_pending = 0
        # the shadow: the state each row's contribution was computed from
        # (s_qrow keeps the queue row of that moment, so a reused row under
        # another queue still subtracts from the right bucket)
        self.s_live = np.zeros((0,), bool)
        self.s_status = np.zeros((0,), np.int8)
        self.s_node = np.zeros((0,), np.int32)
        self.s_job = np.zeros((0,), np.int32)
        self.s_qrow = np.zeros((0,), np.int32)
        self.s_req = np.zeros((0, R), np.float64)
        self.s_be = np.zeros((0,), bool)
        self.s_dynvol = np.zeros((0,), bool)

    _SHADOW = ("s_live", "s_status", "s_node", "s_job", "s_qrow", "s_req", "s_be", "s_dynvol")
    _NODE = ("node_used", "node_rel", "node_tc")
    _JOB = ("job_alloc", "job_ready", "run_ct", "pend_any", "pend_nonbe")
    _QUEUE = ("q_alloc", "q_request")

    def _grow_all(self, names, n: int) -> None:
        for name in names:
            setattr(self, name, _grow(getattr(self, name), n))

    # -- one pod's contribution (the full sweep's predicates) ------------------

    def _contrib(self, sign: int, status: int, node: int, job: int,
                 qrow: int, req: np.ndarray, be: bool, dynvol: bool) -> None:
        if node >= 0:
            if sign > 0:
                self._grow_all(self._NODE, node + 1)
            self.node_used[node] += sign * req
            self.node_tc[node] += sign
            if status == _RELEASING:
                self.node_rel[node] += sign * req
        if sign > 0:
            self._grow_all(self._JOB, job + 1)
            if qrow >= 0:
                self._grow_all(self._QUEUE, qrow + 1)
        if status in _ALLOCATED_CODES:
            self.job_alloc[job] += sign * req
            if qrow >= 0:
                self.q_alloc[qrow] += sign * req
                self.q_request[qrow] += sign * req
        if status in _READY_CODES:
            self.job_ready[job] += sign
        if status == _RUNNING:
            self.run_ct[job] += sign
        if status == _PENDING:
            if qrow >= 0:
                self.q_request[qrow] += sign * req
            self.pend_any[job] += sign
            if not be:
                self.pend_nonbe[job] += sign
            if dynvol:
                self.n_dynvol_pending += sign

    # -- the diff ------------------------------------------------------------------

    def apply(self, m, rows: Iterable[int]) -> None:
        """For each dirty row: subtract its shadow contribution, add its
        current mirror contribution, refresh the shadow.  The dirty set is
        small (the engine builds full past ``DIRTY_STORM``), so a Python
        loop over it stays under the O(P) sweep it replaces."""
        P = len(m.p_live)
        for r in rows:
            r = int(r)
            self._grow_all(self._SHADOW, r + 1)
            if self.s_live[r]:
                self._contrib(-1, int(self.s_status[r]), int(self.s_node[r]),
                              int(self.s_job[r]), int(self.s_qrow[r]), self.s_req[r],
                              bool(self.s_be[r]), bool(self.s_dynvol[r]))
                self.s_live[r] = False
            if r >= P or not m.p_live[r]:
                continue
            job = int(m.p_job[r])
            if job < 0:
                # an unlinked pod contributes nothing (the sweep's
                # ``live &= pod_j >= 0``); it also keeps the fast cycle off
                # until its group arrives
                continue
            status = int(m.p_status[r])
            node = int(m.p_node[r])
            qrow = int(m.j_queue[job])
            req = m.p_resreq[r].astype(np.float64)
            be = bool(m.p_best_effort[r])
            dynvol = bool(m.p_dynamic[r] or m.p_has_vol[r])
            self._contrib(+1, status, node, job, qrow, req, be, dynvol)
            self.s_live[r] = True
            self.s_status[r] = status
            self.s_node[r] = node
            self.s_job[r] = job
            self.s_qrow[r] = qrow
            self.s_req[r] = req
            self.s_be[r] = be
            self.s_dynvol[r] = dynvol
        # rows the mirror holds that no pod has charged yet (a PodGroup
        # whose pods have not arrived) gather as zeros
        self._grow_all(self._NODE, len(m.n_live))
        self._grow_all(self._JOB, len(m.j_live))
        self._grow_all(self._QUEUE, len(m.q_live))

    # -- the full recompute (structural fallback) ----------------------------------

    def rebuild(self, m) -> None:
        """Every accumulator and the shadow recomputed from the mirror,
        vectorized: the reset after a structural event or the first build."""
        P = len(m.p_live)
        R = self.R
        nN, nJ, nQ = len(m.n_live), len(m.j_live), len(m.q_live)
        self.node_used = np.zeros((max(nN, 1), R), np.float64)
        self.node_rel = np.zeros((max(nN, 1), R), np.float64)
        self.node_tc = np.zeros((max(nN, 1),), np.int64)
        self.job_alloc = np.zeros((max(nJ, 1), R), np.float64)
        self.job_ready = np.zeros((max(nJ, 1),), np.int64)
        self.run_ct = np.zeros((max(nJ, 1),), np.int64)
        self.pend_any = np.zeros((max(nJ, 1),), np.int64)
        self.pend_nonbe = np.zeros((max(nJ, 1),), np.int64)
        self.q_alloc = np.zeros((max(nQ, 1), R), np.float64)
        self.q_request = np.zeros((max(nQ, 1), R), np.float64)

        live = m.p_live[:P]
        job = m.p_job[:P]
        elig = live & (job >= 0)
        rows = np.nonzero(elig)[0]
        status = m.p_status[:P]
        node = m.p_node[:P]
        if nJ:
            qrow = np.where(elig, m.j_queue[np.clip(job, 0, nJ - 1)], -1).astype(np.int32)
        else:
            qrow = np.full(P, -1, np.int32)
        req = m.p_resreq[:P].astype(np.float64)
        be = m.p_best_effort[:P]
        dynvol = m.p_dynamic[:P] | m.p_has_vol[:P]

        self.n_dynvol_pending = 0
        if rows.size:
            st, nd, jb, qr, rq = status[rows], node[rows], job[rows], qrow[rows], req[rows]
            resident = nd >= 0
            if resident.any():
                np.add.at(self.node_used, nd[resident], rq[resident])
                self.node_tc[:nN] += np.bincount(nd[resident], minlength=nN)[:nN]
                relm = resident & (st == _RELEASING)
                if relm.any():
                    np.add.at(self.node_rel, nd[relm], rq[relm])
            alloc = np.isin(st, _ALLOCATED_CODES)
            if alloc.any():
                np.add.at(self.job_alloc, jb[alloc], rq[alloc])
                aq = alloc & (qr >= 0)
                if aq.any():
                    np.add.at(self.q_alloc, qr[aq], rq[aq])
                    np.add.at(self.q_request, qr[aq], rq[aq])
            ready = np.isin(st, _READY_CODES)
            if ready.any():
                self.job_ready[:nJ] += np.bincount(jb[ready], minlength=nJ)[:nJ]
            running = st == _RUNNING
            if running.any():
                self.run_ct[:nJ] += np.bincount(jb[running], minlength=nJ)[:nJ]
            pend = st == _PENDING
            if pend.any():
                pq = pend & (qr >= 0)
                if pq.any():
                    np.add.at(self.q_request, qr[pq], rq[pq])
                self.pend_any[:nJ] += np.bincount(jb[pend], minlength=nJ)[:nJ]
                pnb = pend & ~be[rows]
                if pnb.any():
                    self.pend_nonbe[:nJ] += np.bincount(jb[pnb], minlength=nJ)[:nJ]
            self.n_dynvol_pending = int((pend & dynvol[rows]).sum())

        # the shadow: copies of the state just aggregated
        self._grow_all(self._SHADOW, P)
        self.s_live[:P] = elig
        self.s_live[P:] = False
        self.s_status[:P] = status
        self.s_node[:P] = node
        self.s_job[:P] = job
        self.s_qrow[:P] = qrow
        self.s_req[:P] = req
        self.s_be[:P] = be
        self.s_dynvol[:P] = dynvol


def patch_task_planes(m, snap, aux, pe_rows: np.ndarray, nodeaffinity_weight: float) -> None:
    """Rewrite the snapshot's task planes for a filtered pending set
    (admission's held and shed gangs): the one way a delta module writes
    snapshot columns.  The shapes stay the cycle's: the task bucket is
    pinned (``min_T``), and the class planes pad back to the snapshot's C
    when the filtered set has fewer classes (rows past ``n_tasks`` are
    invalid and never read), so the kernels' per-shape workspaces see no
    new key."""
    from volcano_tpu_torch.scheduler.fastpath.snapshot_build import _task_arrays

    N, R = snap.node_idle.shape
    ta = _task_arrays(m, pe_rows, aux["pod_j"], aux["n_jobs"], N, R, aux["node_rows"],
                      aux["n_nodes"], nodeaffinity_weight, snap.job_start, snap.job_ntasks,
                      min_T=snap.task_req.shape[0])
    snap.task_req[:] = ta["task_req"]
    snap.task_job[:] = ta["task_job"]
    snap.task_class[:] = ta["task_class"]
    snap.task_valid[:] = ta["task_valid"]
    snap.task_uids = ta["pod_keys"]
    cm, cs = ta["class_mask"], ta["class_score"]
    nC = cm.shape[0]
    if nC < snap.class_node_mask.shape[0]:
        snap.class_node_mask[:nC] = cm
        snap.class_node_mask[nC:] = False
        snap.class_node_score[:nC] = cs
        snap.class_node_score[nC:] = 0.0
    else:
        snap.class_node_mask[:] = cm[: snap.class_node_mask.shape[0]]
        snap.class_node_score[:] = cs[: snap.class_node_score.shape[0]]
    aux["pe_rows"] = pe_rows
    aux["n_tasks"] = ta["n_tasks"]


#: the aux keys the oracle compares: the row maps and everything the solve,
#: the contention prechecks and publish read
_AUX_KEYS = (
    "pe_rows", "job_rows", "node_rows", "n_jobs", "n_tasks", "n_nodes",
    "pod_j", "live", "codes", "node_used", "run_per_job",
    "pend_any_per_job", "pend_nonbe_per_job", "dyn_job", "dyn_expr_job",
    "partition_unsafe", "shadow_job", "residue_keys", "residue_reasons",
    "residue_task_counts",
)


def _eq(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return a == b


def assert_snapshot_equal(got: Tuple, want: Tuple) -> None:
    """Bit-for-bit comparison of two (snapshot, aux) pairs, the micro
    build ``got`` against the full build ``want`` on the same mirror
    state; AssertionError names the first field that differs."""
    snap_g, aux_g = got
    snap_w, aux_w = want
    if (snap_g is None) != (snap_w is None):
        raise AssertionError(f"snapshot-incremental: one side is None "
                             f"(micro={snap_g is None}, full={snap_w is None})")
    if snap_g is None:
        return
    for f in dataclasses.fields(snap_g):
        a, b = getattr(snap_g, f.name), getattr(snap_w, f.name)
        if a is None and b is None:
            continue
        if not _eq(a, b):
            raise AssertionError(f"snapshot-incremental: snapshot field {f.name!r} "
                                 f"diverges between micro and full build")
    for k in _AUX_KEYS:
        if not _eq(aux_g.get(k), aux_w.get(k)):
            raise AssertionError(f"snapshot-incremental: aux[{k!r}] diverges between "
                                 f"micro and full build")

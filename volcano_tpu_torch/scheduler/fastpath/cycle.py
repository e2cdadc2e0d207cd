"""FastCycle: the array-native cycle driver.

The port's cut of ``volcano_tpu/scheduler/fastpath/cycle.py``: drain ->
snapshot -> enqueue -> allocate solve -> backfill -> dynamic solve ->
publish, with the same ``phases`` keys.  Where the JAX
``FastCycle.try_run`` returns False or hands jobs to its object sub-cycle,
this cycle raises ``NotImplementedError`` naming the ROADMAP item that will
cover the case.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from volcano_tpu_torch.api.types import PodGroupPhase
from volcano_tpu_torch.scheduler.fastpath.mirror import _PENDING, ArrayMirror
from volcano_tpu_torch.scheduler.fastpath.publish import publish_and_close
from volcano_tpu_torch.scheduler.fastpath.snapshot_build import (
    build_dyn_solve_inputs,
    build_fast_snapshot,
)
from volcano_tpu_torch.scheduler.tensor_actions import (
    torch_allocate_solve,
    torch_dynamic_solve,
)
from volcano_tpu_torch.scheduler.tensor_backend import TensorBackend

#: enqueue's overcommit factor (enqueue.go:80)
OVERCOMMIT_FACTOR = 1.2

_OBJECT_PATH = "ROADMAP queue 1 item 8 (object path)"
_ROADMAP_FOR = {
    "pending pods with volumes": "ROADMAP queue 1 item 6 (volume slice)",
}


class FastCycle:
    def __init__(self, scheduler):
        self.sched = scheduler
        self.cache = scheduler.cache
        self.store = scheduler.cache.store
        self.conf = scheduler.conf
        self.probe = TensorBackend(self.conf.tiers, scheduler.device, scheduler.uploads)
        self.gang_on = self.probe.gang_job_ready
        self.nodeaffinity_weight = self.probe.nodeaffinity_weight()
        self.mirror = None
        #: wall seconds per phase of the last try_run
        self.phases: Dict[str, float] = {}
        # pg key -> (phase, running, failed, succeeded, message) last written
        self._status_fp: Dict[str, tuple] = {}
        self._err_seen = 0

    def conf_unsupported(self):
        """Why the conf is outside this port's slice, or None."""
        storm = [a for a in ("reclaim", "preempt") if a in self.conf.actions]
        if storm:
            return (f"actions {storm}: ROADMAP queue 1 item 7 (contention slice)")
        if self.probe.unsupported:
            return f"plugins {self.probe.unsupported}: {_OBJECT_PATH}"
        canonical = iter(["enqueue", "allocate", "backfill"])
        if "allocate" not in self.conf.actions or not all(
                a in canonical for a in self.conf.actions):
            return f"action order {self.conf.actions}: {_OBJECT_PATH}"
        return None

    def sync_mirror(self) -> None:
        if self.mirror is None:
            self.mirror = ArrayMirror(
                self.store, self.cache.scheduler_name, self.cache.default_queue)
        self.mirror.drain()

    def try_run(self) -> bool:
        why = self.conf_unsupported()
        if why:
            raise NotImplementedError(why)
        ph = self.phases = {}
        t = time.perf_counter()
        self.sync_mirror()
        m = self.mirror
        self._reconcile_failures(m)
        ph["drain"] = time.perf_counter() - t
        why = m.ineligible_reason()
        if why is not None:
            raise NotImplementedError(f"{why}: {_ROADMAP_FOR.get(why, _OBJECT_PATH)}")
        t = time.perf_counter()
        snap, aux = build_fast_snapshot(m, self.nodeaffinity_weight)
        ph["snapshot"] = time.perf_counter() - t
        if snap is None:
            raise NotImplementedError(f"cluster without queues: {_OBJECT_PATH}")
        if aux["partition_unsafe"]:
            raise NotImplementedError(
                "a dynamic job outranks an express job in its queue "
                f"(partition unsafe): {_OBJECT_PATH}")
        if aux["residue_keys"]:
            why = sorted(set(aux["residue_reasons"].values()))
            raise NotImplementedError(
                f"dynamic jobs the device solve cannot express ({', '.join(why)}): "
                f"{_OBJECT_PATH}")

        enq_ops: List[dict] = []
        if "enqueue" in self.conf.actions:
            t = time.perf_counter()
            enq_ops = self._enqueue_ops(m, aux, self._enqueue(m, snap, aux))
            ph["enqueue"] = time.perf_counter() - t

        t = time.perf_counter()
        backend = TensorBackend(
            self.conf.tiers, self.sched.device, self.sched.uploads,
            solve_mode=self.conf.solve_mode)
        backend.snapshot = snap
        if aux["n_tasks"]:
            task_node, task_kind, task_seq, ready = torch_allocate_solve(backend, snap)
        else:
            T = snap.task_req.shape[0]
            task_node = np.zeros(T, np.int32)
            task_kind = np.zeros(T, np.int32)
            ready = snap.job_ready_init.copy()
        ph["solve"] = time.perf_counter() - t

        t = time.perf_counter()
        if "backfill" in self.conf.actions:
            be_rows, be_nodes, be_per_job = self._backfill(m, snap, aux, task_node, task_kind)
        else:
            be_rows, be_nodes = np.zeros(0, np.int64), np.zeros(0, np.int32)
            be_per_job = np.zeros(snap.job_min_available.shape[0], np.int64)
        ph["backfill"] = time.perf_counter() - t

        # the dynamic pass: dyn-expr jobs (host ports, pod (anti)affinity)
        # run the solve with the portsel extension over the state the
        # express solve and backfill left, and merge into the publish
        # layout: express task rows first, then the dynamic ones
        pe_rows_solve, task_job_solve, task_req_solve = aux["pe_rows"], snap.task_job, snap.task_req
        if aux["dyn_expr_job"][:max(aux["n_jobs"], 1)].any():
            t = time.perf_counter()
            dyn = build_dyn_solve_inputs(m, snap, aux, self.nodeaffinity_weight,
                                         task_node, task_kind, be_rows, be_nodes, ready)
            if dyn is not None:
                d_node, d_kind, _, d_ready = torch_dynamic_solve(backend, snap, dyn)
                # task arrays are bucket-padded, row maps are not: pad each
                # region's row map to its task length (padding rows have
                # task_kind 0 and are never read)
                pe_pad = np.full(snap.task_req.shape[0], -1, np.int64)
                pe_pad[: pe_rows_solve.size] = pe_rows_solve
                dyn_pad = np.full(dyn["task_req"].shape[0], -1, np.int64)
                dyn_pad[: dyn["rows"].size] = dyn["rows"]
                task_node = np.concatenate([task_node, d_node])
                task_kind = np.concatenate([task_kind, d_kind])
                pe_rows_solve = np.concatenate([pe_pad, dyn_pad])
                task_job_solve = np.concatenate([task_job_solve, dyn["task_job"]])
                task_req_solve = np.concatenate([task_req_solve, dyn["task_req"]])
                dmask = np.zeros(ready.shape[0], bool)
                dmask[:aux["n_jobs"]] = aux["dyn_expr_job"][:aux["n_jobs"]]
                ready = np.where(dmask, d_ready, ready)
            ph["dyn_solve"] = time.perf_counter() - t

        t = time.perf_counter()
        publish_and_close(self, m, snap, aux, task_node, task_kind, ready,
                          be_rows, be_nodes, be_per_job,
                          pe_rows_solve, task_job_solve, task_req_solve)
        self._ship_enqueue_ops(enq_ops)
        ph["publish"] = time.perf_counter() - t
        return True

    def _reconcile_failures(self, m: ArrayMirror) -> None:
        """Failed writes mean the mirror's optimistic rows (or the status
        fingerprints) never reached the store — re-read them."""
        err = self.cache.err_log
        for op, key, _ in err[self._err_seen:]:
            if op == "bind":
                m.refresh_pod(key)
            elif op == "status":
                self._status_fp.pop(key, None)
                pg = self.store.get("PodGroup", key)
                if pg is not None:
                    m._on_podgroup(pg)
        self._err_seen = len(err)

    # -- enqueue (enqueue.go:42-128 over arrays) -----------------------------

    def _enqueue(self, m: ArrayMirror, snap, aux) -> List[int]:
        n_jobs = aux["n_jobs"]
        if not n_jobs:
            return []
        pending_jobs = np.nonzero(~snap.job_schedulable[:n_jobs])[0]
        if not pending_jobs.size:
            return []
        idle = np.maximum(
            snap.node_alloc * OVERCOMMIT_FACTOR - aux["node_used"], 0.0
        )[snap.node_valid].sum(0)
        eps = snap.eps
        # jobs with pending pods or an empty MinResources admit at once;
        # budgeted jobs go in the queue round-robin's visit order
        min_reqs = m.j_min_req[aux["job_rows"][pending_jobs]]
        uncond = (
            (aux["pend_any_per_job"][pending_jobs] > 0)
            | (min_reqs < eps[None, :]).all(1)
        )
        admitted = [int(j) for j in pending_jobs[uncond]]
        if not uncond.all():
            qk = snap.job_queue[pending_jobs]
            order = np.lexsort((pending_jobs, -snap.job_priority[pending_jobs], qk))
            q_sorted = qk[order]
            run_start = np.searchsorted(q_sorted, q_sorted, side="left")
            rank = np.empty(order.size, np.int64)
            rank[order] = np.arange(order.size) - run_start
            budg = np.nonzero(~uncond)[0]
            for i in budg[np.lexsort((qk[budg], rank[budg]))]:
                j = int(pending_jobs[i])
                min_req = m.j_min_req[aux["job_rows"][j]]
                if bool((min_req < idle + eps).all()):
                    idle -= min_req
                    admitted.append(j)
        inqueue = m._phase_idx[PodGroupPhase.INQUEUE]
        for j in admitted:
            snap.job_schedulable[j] = True
            m.j_phase[aux["job_rows"][j]] = inqueue
        return admitted

    def _enqueue_ops(self, m, aux, admitted) -> List[dict]:
        """Admitted groups' Pending -> Inqueue flips as conditional patches."""
        return [
            {"op": "patch", "kind": "PodGroup",
             "key": m.jobs.row_key[aux["job_rows"][j]],
             "fields": {"status.phase": PodGroupPhase.INQUEUE},
             "when": {"status.phase": PodGroupPhase.PENDING}}
            for j in admitted
        ]

    def _ship_enqueue_ops(self, ops: List[dict]) -> None:
        if not ops:
            return
        for op, err in zip(ops, self.store.bulk(ops)):
            if err is not None and not err.startswith("PreconditionFailed"):
                self.cache._record_err("status", op["key"], RuntimeError(err))

    # -- backfill (backfill.go:41-78 over arrays) ----------------------------

    def _backfill(self, m, snap, aux, task_node, task_kind):
        J = snap.job_min_available.shape[0]
        be_per_job = np.zeros(J, np.int64)
        P = len(m.p_live)
        be = (
            aux["live"] & (aux["codes"][:P] == _PENDING) & m.p_best_effort[:P]
            & (m.p_req[:P] < snap.eps[None, :]).all(1)
        )
        be_rows = np.nonzero(be)[0]
        if be_rows.size:
            be_rows = be_rows[snap.job_schedulable[aux["pod_j"][be_rows]]]
        if not be_rows.size:
            return np.zeros(0, np.int64), np.zeros(0, np.int32), be_per_job
        # node task counts after the allocate pass
        counts = snap.node_task_count.copy()
        placed = np.nonzero(task_kind > 0)[0]
        if placed.size:
            counts += np.bincount(task_node[placed], minlength=counts.shape[0]).astype(counts.dtype)
        n_nodes = aux["n_nodes"]
        max_tasks = snap.node_max_tasks[:n_nodes]
        # jobs in creation order, tasks by arrival
        be_rows = be_rows[np.lexsort((m.p_rank[be_rows], aux["pod_j"][be_rows]))]
        be_cls = m.p_class[be_rows].astype(np.int64)
        ucids = np.unique(be_cls)
        m.fill_class_cells(ucids, aux["node_rows"], self.nodeaffinity_weight)
        cls_masks = {int(c): m.cls_mask[c, aux["node_rows"]] for c in ucids}
        out_nodes = np.full(be_rows.size, -1, np.int32)
        # first fit is monotone per class: one forward pointer per class
        ptrs = {int(c): 0 for c in ucids}
        for i in range(be_rows.size):
            cid = int(be_cls[i])
            mask = cls_masks[cid]
            ptr = ptrs[cid]
            while ptr < n_nodes and not (mask[ptr] and counts[ptr] < max_tasks[ptr]):
                ptr += 1
            ptrs[cid] = ptr
            if ptr >= n_nodes:
                continue
            out_nodes[i] = ptr
            counts[ptr] += 1
        ok = out_nodes >= 0
        be_rows, out_nodes = be_rows[ok], out_nodes[ok]
        if be_rows.size:
            np.add.at(be_per_job, aux["pod_j"][be_rows], 1)
        return be_rows, out_nodes, be_per_job

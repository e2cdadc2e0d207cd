"""FastCycle: the array-native cycle driver.

The port's cut of ``volcano_tpu/scheduler/fastpath/cycle.py``: drain ->
snapshot (with the volume verdicts, timed as ``vol_solve`` when volume
pods are pending) -> enqueue -> reclaim -> allocate solve -> backfill ->
dynamic solve -> preempt -> publish, with the same ``phases`` keys.  Reclaim and
preempt run only when their conservative prechecks find possible work
(``_reclaim_possible``, ``_preempt_possible``), through ``FastContention``
(``scheduler/fast_victims.py``).  Where the JAX ``FastCycle.try_run``
returns False, this one does too (after shipping the enqueue admissions it
already made), and the scheduler runs the whole cycle on the object path.
Work the device passes cannot express runs after publish in the object
sub-cycle (``Scheduler.run_object_residue``), timed as ``subcycle`` with the
residue engine's share as ``residue_vec``: the residue jobs (intern-cap
overflow, best-effort pods of dynamic jobs, volume shapes the count model
cannot hold) and the preempt of a cycle with dynamic-predicate jobs, or one
whose reference walk would strand evictions.
Under a conf mesh the batched solves (the express one and the dynamic
one) run on node blocks, and with ``solve_mode="batch"`` the contention
passes too (K15a-c), as the JAX cycle shards them there.
Under ``mesh_hosts > 1`` every host runs the same global solve and fetches
only its owned task block; a worker (``mesh_host_id != 0``) publishes only
those binds, and the coordinator also owns the dynamic and best-effort
placements, the PodGroup statuses and the enqueue admissions.
With the cache's async applier the enqueue admissions go to it after
publish; they are shipped synchronously before an object sub-cycle and on
every exit to the object path, whose sessions read the store's phases.
Under ``delta: on`` a ``DeltaEngine`` (``scheduler/delta/``) builds the
snapshot: a micro build from the watch's dirty rows where it can, a full
build with its reason where it cannot, and again full (``contention``)
when a micro-built cycle finds reclaim or preempt work.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Set

import numpy as np

from volcano_tpu_torch import timeseries
from volcano_tpu_torch.api.types import PodGroupPhase
from volcano_tpu_torch.native import water_fill_np
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.scheduler.fast_victims import FastContention, _rebuild_task_arrays
from volcano_tpu_torch.scheduler.fastpath.mirror import _PENDING, _RELEASING, ArrayMirror
from volcano_tpu_torch.scheduler.fastpath.publish import publish_and_close
from volcano_tpu_torch.scheduler.fastpath.snapshot_build import (
    build_dyn_solve_inputs,
    build_fast_snapshot,
    build_victim_pool,
)
from volcano_tpu_torch.scheduler.tensor_actions import (
    torch_allocate_solve,
    torch_dynamic_solve,
)
from volcano_tpu_torch.scheduler.tensor_backend import TensorBackend

#: enqueue's overcommit factor (enqueue.go:80)
OVERCOMMIT_FACTOR = 1.2


class FastCycle:
    def __init__(self, scheduler):
        self.sched = scheduler
        self.cache = scheduler.cache
        self.store = scheduler.cache.store
        self.conf = scheduler.conf
        self.probe = TensorBackend(self.conf.tiers, scheduler.device, scheduler.uploads,
                                   solve_mode=self.conf.solve_mode,
                                   mesh=getattr(scheduler, "mesh", None))
        self.gang_on = self.probe.gang_job_ready
        self.nodeaffinity_weight = self.probe.nodeaffinity_weight()
        # multi-controller launch: host h publishes only the binds of its
        # owned task block; host 0, the coordinator, also owns statuses,
        # enqueue admissions, the dynamic and best-effort placements
        self.mesh_hosts = max(int(self.conf.mesh_hosts), 1)
        self.mesh_host_id = int(self.conf.mesh_host_id)
        self.is_coordinator = self.mesh_host_id == 0
        self.mirror = None
        #: the mirror came from conf.mirror_checkpoint, not a full list
        self.restored_from_checkpoint = False
        #: wall seconds per phase of the last try_run
        self.phases: Dict[str, float] = {}
        #: residue job key -> the class that kept it off the device, last cycle
        self.last_residue_reasons: Dict[str, str] = {}
        #: the residue engine's {"tasks", "seconds"} in the last sub-cycle
        self.residue_stats: Dict[str, float] = {}
        # pg key -> (phase, running, failed, succeeded, message) last written
        self._status_fp: Dict[str, tuple] = {}
        # pg key -> the Unschedulable message of its last Warning Event
        self._last_unsched: Dict[str, str] = {}
        self._err_seen = 0
        # publish clears the volume binder's session once a cycle
        self._vol_session_cleared = False
        #: the last fast cycle's backlog, binds, evictions, residue jobs and,
        #: under delta, the engine's mode, reason and admission depths; set
        #: only while the time-series recorder is armed
        self.last_cycle_stats: Dict[str, object] = {}
        #: the incremental engine under ``conf.delta == "on"``, else None
        self.delta = None
        if self.conf_ok() and self.conf.delta == "on":
            from volcano_tpu_torch.scheduler.delta import DeltaEngine

            self.delta = DeltaEngine(self.conf, self.store)

    def conf_ok(self) -> bool:
        """False for plugins the tensor path does not model, and for action
        orders that are not a subsequence of the canonical one (the object
        path runs those in literal conf order)."""
        if self.probe.unsupported:
            return False
        canonical = iter(["enqueue", "reclaim", "allocate", "backfill", "preempt"])
        return "allocate" in self.conf.actions and all(
            a in canonical for a in self.conf.actions)

    def sync_mirror(self) -> None:
        """The mirror's one full list (``Scheduler.prewarm`` calls this so
        that the first cycle pays only watch deltas), then its drains.  With
        ``conf.mirror_checkpoint`` naming a checkpoint this store lineage
        can take, the list becomes a restore and a delta reconcile by
        per-object resource version (``restored_from_checkpoint``)."""
        if not self.conf_ok():
            return
        if self.mirror is None:
            self.mirror = ArrayMirror(
                self.store, self.cache.scheduler_name, self.cache.default_queue)
            if self.delta is not None:
                # a new mirror, restored or listed: the first build is full
                self.delta.arm(self.mirror)
            ckpt = self.conf.mirror_checkpoint
            if ckpt and os.path.exists(ckpt) and self.mirror.try_restore_checkpoint(ckpt):
                self.restored_from_checkpoint = True
                return
        if self.delta is not None:
            # before the drain: the hook sees this cycle's watch events
            self.delta.arm(self.mirror)
        self.mirror.drain()

    def reset_after_abort(self) -> None:
        """Leadership loss dropped queued decisions (applier.abort_pending):
        the mirror's optimistic rows and the status fingerprints no longer
        match the store, so they are rebuilt from a fresh list."""
        self._status_fp.clear()
        self._last_unsched.clear()
        if self.mirror is not None:
            self.mirror._resync(dims=self.mirror.dims)

    def try_run(self) -> bool:
        """One fast cycle; False (nothing published) where the cycle needs
        the object path."""
        if not self.conf_ok():
            return False
        ph = self.phases = {}
        self.residue_stats = {}
        self._vol_session_cleared = False
        t = time.perf_counter()
        self.sync_mirror()
        m = self.mirror
        self._reconcile_failures(m)
        ph["drain"] = time.perf_counter() - t
        if m.ineligible_reason() is not None:
            return False
        t = time.perf_counter()
        dyn_batch = (self.conf.solve_mode, self.probe.batch_threshold)
        if self.delta is not None:
            snap, aux = self.delta.build(m, self.nodeaffinity_weight, dyn_batch=dyn_batch)
        else:
            snap, aux = build_fast_snapshot(m, self.nodeaffinity_weight, dyn_batch=dyn_batch)
        ph["snapshot"] = time.perf_counter() - t
        if snap is None:
            return False
        if aux["vol_solve_s"]:
            # the volume verdicts, carved out of the snapshot phase; the
            # phase appears only when volume pods are pending
            ph["vol_solve"] = aux["vol_solve_s"]
            ph["snapshot"] -= aux["vol_solve_s"]
        self.last_residue_reasons = dict(aux["residue_reasons"])
        if aux["partition_unsafe"]:
            # a dynamic job outranks an express job in its queue: a
            # device-first pass would invert priority under contention
            return False
        reclaim_work = "reclaim" in self.conf.actions and self._reclaim_possible(snap, aux)

        # preempt is the last action: it runs only if starving tasks remain
        # after the allocate, backfill and dynamic passes
        preempt_later = "preempt" in self.conf.actions and self._preempt_possible(snap, aux)
        if (self.delta is not None and self.delta.last["mode"] == "micro"
                and (reclaim_work or preempt_later)):
            # a contention wave is structural: the full build on the same
            # mirror state before the victim pool is carved (the prechecks
            # hold, and the cached admission decision re-applies)
            t = time.perf_counter()
            snap, aux = self.delta.rebuild_full(m, self.nodeaffinity_weight,
                                                dyn_batch=dyn_batch)
            ph["snapshot"] += time.perf_counter() - t
            if snap is None:
                return False
            self.last_residue_reasons = dict(aux["residue_reasons"])

        enq_ops: List[dict] = []
        if "enqueue" in self.conf.actions:
            t = time.perf_counter()
            enq_ops = self._enqueue_ops(m, aux, self._enqueue(m, snap, aux))
            ph["enqueue"] = time.perf_counter() - t

        dyn_any = bool(aux["dyn_expr_job"][:max(aux["n_jobs"], 1)].any())
        cont = None
        if reclaim_work:
            # reclaimers with host ports, pod (anti)affinity or an empty
            # request need the object walk for the whole cycle; nothing is
            # published yet, so the object path re-runs it from the store
            if aux["residue_keys"] or dyn_any or self._pending_best_effort(m, snap, aux):
                return self._object_path(enq_ops)
            t = time.perf_counter()
            cont = self._make_contention(snap, aux)
            if not cont.reclaim_pass():
                # the reference's walk would strand evictions (clean=False)
                return self._object_path(enq_ops)
            cont.fold_into_snapshot(m)
            metrics.update_action_duration("reclaim", t)
            ph["reclaim"] = time.perf_counter() - t

        t = time.perf_counter()
        backend = TensorBackend(
            self.conf.tiers, self.sched.device, self.sched.uploads,
            solve_mode=self.conf.solve_mode, mesh=self.sched.mesh)
        backend.snapshot = snap
        if self.mesh_hosts > 1:
            # the owned-slice fetch: only this host's task block comes back
            backend.mesh_host = self.mesh_host_id
            backend.mesh_hosts = self.mesh_hosts
        if aux["n_tasks"]:
            task_node, task_kind, task_seq, ready = torch_allocate_solve(backend, snap)
        else:
            T = snap.task_req.shape[0]
            task_node = np.zeros(T, np.int32)
            task_kind = np.zeros(T, np.int32)
            ready = snap.job_ready_init.copy()
        metrics.update_action_duration("allocate", t)
        ph["solve"] = time.perf_counter() - t

        t = time.perf_counter()
        if "backfill" in self.conf.actions:
            be_rows, be_nodes, be_per_job = self._backfill(m, snap, aux, task_node, task_kind)
        else:
            be_rows, be_nodes = np.zeros(0, np.int64), np.zeros(0, np.int32)
            be_per_job = np.zeros(snap.job_min_available.shape[0], np.int64)
        ph["backfill"] = time.perf_counter() - t

        residue = bool(aux["residue_keys"])
        unplaced = bool((snap.task_valid & (task_kind == 0)).any())
        # the dynamic pass: dyn-expr jobs (host ports, pod (anti)affinity)
        # run the solve with the portsel extension over the state the
        # express solve and backfill left, and merge into the publish
        # layout: express task rows first, then the dynamic ones.  The
        # preempt pass may re-pack the task arrays; publish keeps the
        # solve's layout
        pe_rows_solve, task_job_solve, task_req_solve = aux["pe_rows"], snap.task_job, snap.task_req
        dyn_unplaced = False
        if dyn_any:
            t = time.perf_counter()
            dyn = build_dyn_solve_inputs(m, snap, aux, self.nodeaffinity_weight,
                                         task_node, task_kind, be_rows, be_nodes, ready)
            if dyn is not None:
                d_node, d_kind, _, d_ready = torch_dynamic_solve(backend, snap, dyn)
                dyn_unplaced = bool((dyn["task_valid"] & (d_kind == 0)).any())
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

        be_left = self._pending_best_effort(m, snap, aux, minus_placed=be_rows)
        obj_preempt = False
        if preempt_later and (unplaced or residue or be_left or dyn_unplaced):
            if residue or dyn_any:
                # residue preemptors, or any dynamic job in the cycle (the
                # contention state folds only the express task layout): the
                # object preempt runs in the sub-cycle, a whole object cycle
                # once the reclaim pass holds unpublished records
                if cont is not None and (cont.evictions or cont.pipelines):
                    return self._object_path(enq_ops)
                obj_preempt = True
            else:
                t = time.perf_counter()
                if cont is None:
                    cont = self._make_contention(snap, aux)
                cont.advance_post_solve(task_node, task_kind, ready, be_rows, be_nodes)
                if be_left:
                    # empty-request preemptors join the task arrays (the
                    # victim core takes exactly one victim for them, as the
                    # host loop)
                    placed_mask = self._repack_with_best_effort(m, snap, aux, cont, task_kind,
                                                                be_rows)
                else:
                    placed_mask = task_kind > 0
                if not cont.preempt_pass(placed_mask):
                    # the reference's walk would strand evictions
                    # (clean=False): its records were rolled back; reclaim's
                    # must not publish without the preempt after them
                    if cont.evictions or cont.pipelines:
                        return self._object_path(enq_ops)
                    obj_preempt = True
                metrics.update_action_duration("preempt", t)
                ph["preempt"] = time.perf_counter() - t

        if not self.is_coordinator:
            # owned-slice publish: the fetch zero-filled the express rows
            # outside this host's block; the dynamic rows and the backfill
            # placements are the coordinator's.  The gang gate counts no
            # backfill here (a gang made ready only by best-effort pods
            # gates closed on the worker this cycle and heals next cycle)
            T_express = snap.task_req.shape[0]
            if task_kind.shape[0] > T_express:
                task_kind = task_kind.copy()
                task_kind[T_express:] = 0
            be_rows = np.zeros(0, np.int64)
            be_nodes = np.zeros(0, np.int32)
            be_per_job = np.zeros_like(be_per_job)
        # a worker never runs the object sub-cycle: the residue and the
        # object preempt are the coordinator's
        run_sub = (residue or obj_preempt) and self.is_coordinator
        if run_sub:
            # the sub-cycle's close_session reads store phases: the
            # admissions land first
            self._ship_enqueue_ops(enq_ops)
            for cls_name, n in aux["residue_task_counts"].items():
                metrics.register_residue_tasks(cls_name, n)
        t = time.perf_counter()
        try:
            evicts, ready_status = self._collect_contention(m, snap, aux, cont)
            # with a sub-cycle, its close_session owns the PodGroup statuses:
            # it sees the residue placements and the preempt's pipelines
            pub_binds = publish_and_close(self, m, snap, aux, task_node, task_kind, ready,
                                          be_rows, be_nodes, be_per_job,
                                          pe_rows_solve, task_job_solve, task_req_solve,
                                          evicts=evicts, ready_status=ready_status,
                                          write_status=not run_sub and self.is_coordinator)
        finally:
            if not run_sub and enq_ops and self.is_coordinator:
                # nothing of this cycle reads the store's phases: the
                # conditional patches ride the applier, submitted after
                # publish so that its first batch does not take the GIL
                # inside the measured section, and in a finally so that a
                # publish failure cannot strand the mirror's admissions
                applier = self.cache.applier
                if applier is not None:
                    applier.submit_ops(enq_ops)
                else:
                    self._ship_enqueue_ops(enq_ops)
        ph["publish"] = time.perf_counter() - t
        if timeseries.RECORDER is not None:
            # the cycle row's fields, already computed; unarmed, the cycle
            # pays this one attribute check
            self.last_cycle_stats = {
                "backlog": int(aux["n_tasks"]), "binds": len(pub_binds),
                "evictions": len(evicts), "residue_jobs": len(self.last_residue_reasons)}
            if self.delta is not None:
                self.last_cycle_stats.update(self.delta.last)
        if run_sub:
            # the sub-cycle's snapshot sees this cycle's published binds
            # whatever the bind seam wrote to the store
            self.cache.cycle_overlay = dict(pub_binds)
            t = time.perf_counter()
            try:
                self._object_subcycle(aux["residue_keys"], obj_preempt)
            finally:
                self.cache.cycle_overlay = {}
                ph["subcycle"] = time.perf_counter() - t
                if self.residue_stats.get("seconds"):
                    ph["residue_vec"] = self.residue_stats["seconds"]
        return True

    def _object_path(self, enq_ops) -> bool:
        """Decline the cycle for the object path.  Admissions already
        flipped in the mirror reach the store first, so that the object
        session reads them."""
        self._ship_enqueue_ops(enq_ops)
        return False

    def _object_subcycle(self, residue_keys: Set[str], run_preempt: bool) -> None:
        """Work that survived the device passes and needs the object
        machinery: the residue jobs' allocate and backfill, and the preempt
        action if ``run_preempt``, in one session that sees the published
        binds and writes the cycle's PodGroup statuses."""
        self.sched.run_object_residue(residue_keys, run_preempt)
        # close_session wrote statuses the fast fingerprints do not know
        self._status_fp.clear()

    # -- contention (fast_victims.py) ------------------------------------------

    def _make_contention(self, snap, aux) -> FastContention:
        """The victim pool and the contention driver, built only on cycles
        whose prechecks found possible work; ``deserved`` comes from the host
        water-fill, as in the reference cycle."""
        build_victim_pool(self.mirror, snap, aux)
        deserved = water_fill_np(snap.queue_weight, snap.queue_request, snap.total,
                                 snap.eps, snap.queue_participates)
        return FastContention(self, snap, aux, deserved)

    def _repack_with_best_effort(self, m, snap, aux, cont, task_kind, be_rows) -> np.ndarray:
        """Rebuild the task arrays with the pending best-effort rows of
        schedulable express jobs (the host preemptor walk includes them;
        allocate and backfill do not).  Returns the placed mask over the new
        arrays: rows the solve placed stay out of the preemptor walk."""
        P = aux["codes"].shape[0]
        be = aux["live"] & (aux["codes"] == _PENDING) & m.p_best_effort[:P]
        rows = np.nonzero(be)[0]
        if rows.size:
            rows = rows[snap.job_schedulable[aux["pod_j"][rows]]]
        if rows.size:
            rows = rows[~aux["dyn_job"][aux["pod_j"][rows]]]
        if be_rows.size and rows.size:
            rows = np.setdiff1d(rows, be_rows, assume_unique=False)
        pe_rows = aux["pe_rows"]
        placed_mirror = pe_rows[np.nonzero(task_kind > 0)[0]]
        combined = np.concatenate([pe_rows, rows])
        combined = combined[np.lexsort((m.p_rank[combined], -m.p_prio[combined],
                                        aux["pod_j"][combined]))]
        _rebuild_task_arrays(m, self, snap, aux, combined)
        cont.refresh_for_preempt(snap)
        new_pe = aux["pe_rows"]
        placed_mask = np.zeros(snap.task_req.shape[0], bool)
        if placed_mirror.size:
            placed_mask[: new_pe.size] = np.isin(new_pe, placed_mirror)
        return placed_mask

    def _pending_best_effort(self, m, snap, aux, minus_placed=None) -> bool:
        """Any pending empty-request task of a schedulable job.
        ``minus_placed``: mirror rows backfill placed this cycle."""
        P = aux["codes"].shape[0]
        be = aux["live"] & (aux["codes"] == _PENDING) & m.p_best_effort[:P]
        rows = np.nonzero(be)[0]
        if not rows.size:
            return False
        rows = rows[snap.job_schedulable[aux["pod_j"][rows]]]
        if minus_placed is not None and minus_placed.size and rows.size:
            rows = np.setdiff1d(rows, minus_placed, assume_unique=False)
        return bool(rows.size)

    def _collect_contention(self, m, snap, aux, cont):
        """The passes' evictions as (pod_key, reason), with the mirror rows
        and the status counts moved to RELEASING, and the cycle's end-state
        ready counts for the status writes (only once the preempt pass
        folded the solve in; reclaim's evictions already reach the solve's
        own ready output)."""
        if cont is None or not (cont.evictions or cont.pipelines):
            return [], None
        evicts = []
        run_rows = aux["run_rows"]
        codes = aux["codes"]
        h = m.delta_hook
        for i, reason in cont.evictions:
            prow = int(run_rows[i])
            m.p_status[prow] = _RELEASING
            codes[prow] = _RELEASING
            if h is not None:
                h.pod(prow)
            evicts.append((snap.run_uids[i], reason))
        return evicts, (cont.occ.copy() if cont.advanced else None)

    # -- prechecks (conservative: False means the action has no work) --------

    def _gang_escape(self, snap, aux, veto) -> np.ndarray:
        """Per job: could gang's veto permit evicting one of its tasks
        (min <= occupied - 1 or min == 1)?  All True when gang does not
        veto; the other vetoes count as permissive."""
        n_jobs = aux["n_jobs"]
        if "gang" not in veto:
            return np.ones(n_jobs, bool)
        jm = snap.job_min_available[:n_jobs]
        occupied = snap.job_ready_init[:n_jobs]
        return (occupied - 1 >= jm) | (jm == 1)

    def _preempt_possible(self, snap, aux) -> bool:
        n_jobs = aux["n_jobs"]
        if not n_jobs:
            return False
        veto_p, _ = self.probe.victim_vetoes()
        escape = self._gang_escape(snap, aux, veto_p)
        run_per_job = aux["run_per_job"][:n_jobs]
        # dynamic and best-effort pending count too: the host preemptor walk
        # attempts them
        pend_per_job = aux["pend_any_per_job"][:n_jobs]
        Q = snap.queue_weight.shape[0]
        q_pending = np.zeros(Q, bool)
        q_victims = np.zeros(Q, bool)
        jq = snap.job_queue[:n_jobs]
        q_pending[jq[pend_per_job > 0]] = True
        q_victims[jq[(run_per_job > 0) & escape]] = True
        # phase 1: same queue, other jobs
        if bool((q_pending & q_victims).any()):
            return True
        # phase 2: within-job
        return bool(((pend_per_job > 0) & (run_per_job > 0) & escape).any())

    def _reclaim_possible(self, snap, aux) -> bool:
        n_jobs = aux["n_jobs"]
        if not n_jobs:
            return False
        _, veto_r = self.probe.victim_vetoes()
        escape = self._gang_escape(snap, aux, veto_r)
        run_per_job = aux["run_per_job"][:n_jobs]
        pend_per_job = aux["pend_nonbe_per_job"][:n_jobs]
        Q = snap.queue_weight.shape[0]
        q_pending = np.zeros(Q, bool)
        q_victims = np.zeros(Q, bool)
        jq = snap.job_queue[:n_jobs]
        q_pending[jq[pend_per_job > 0]] = True
        q_victims[jq[(run_per_job > 0) & escape]] = True
        if self.probe.enabled.get("proportion"):
            deserved = water_fill_np(snap.queue_weight, snap.queue_request, snap.total,
                                     snap.eps, snap.queue_participates)
            # starving queues at or above deserved are skipped (overused)
            overused = ((deserved < snap.queue_alloc_init)
                        | (np.abs(snap.queue_alloc_init - deserved) < snap.eps[None, :])).all(1)
            q_pending &= ~overused
            if "proportion" in veto_r:
                # proportion only releases victims of over-deserved queues
                q_victims &= (snap.queue_alloc_init > deserved + snap.eps[None, :]).any(1)
        if not q_pending.any() or not q_victims.any():
            return False
        # victims must come from another queue than the starving one
        if (q_pending & ~q_victims).any() or (q_victims & ~q_pending).any():
            return True
        return bool((q_pending & q_victims).sum() > 1)

    def _reconcile_failures(self, m: ArrayMirror) -> None:
        """Failed writes (inline or on the applier) mean the mirror's
        optimistic rows (or the status fingerprints) never reached the store
        — re-read them."""
        err = self.cache.err_log
        for op, key, _ in err[self._err_seen:]:
            if not key or "/" not in key:
                continue
            if op in ("bind", "evict"):
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
        if not ops or not self.is_coordinator:
            # admissions are the coordinator's (a worker computes them for
            # the solve's inputs and never writes them)
            return
        try:
            results = self.store.bulk(ops)
        except Exception as e:  # noqa: BLE001 — store outage: retried next cycle
            for op in ops:
                self.cache._record_err("status", op["key"], e)
            return
        for op, err in zip(ops, results):
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
        if be_rows.size:
            # dynamic jobs backfill in the object sub-cycle (a best-effort
            # pod beside host ports needs the resident-state predicates)
            be_rows = be_rows[~aux["dyn_job"][aux["pod_j"][be_rows]]]
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

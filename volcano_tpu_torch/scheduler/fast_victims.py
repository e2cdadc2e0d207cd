"""FastContention: reclaim and preempt over the fast snapshot (K11).

The port's copy of ``volcano_tpu/scheduler/fast_victims.py``.  It keeps
the reference's loop structure — per-queue priority queues, a statement
per preemptor job, one victim solve per preemptor — but runs each whole
pass as one device program (``victim_kernels.reclaim_solve`` /
``preempt_solve``, and ``preempt_rounds`` for storms wider than
``CONTENTION_BATCH_THRESHOLD`` preemptor tasks), so a pass costs one
upload of its state, one launch and ONE fetch, whatever the storm's size.

This module has no kernel of its own.  It holds the cycle-constant victim
arrays (``VictimConsts``) on the scheduler's device, keeps the session
state host-resident between passes (the solves take it up and hand their
final state back in the pass's one fetch), and turns the solves' records
(victim row -> ok-attempt sequence, preemptor task -> node and sequence)
into the ordered eviction and pipeline lists the cycle publishes.

Under a conf mesh with ``solve_mode="batch"`` (``TensorBackend.victim_sharded``,
the decision the object path's victim solve takes too; the JAX module's
``fast_victims.py:148-163``) the node planes of the constants and of the
uploaded state split into the mesh's blocks of rows, each pass runs its
solve on them (``victim_kernels.reclaim_solve_sharded`` /
``preempt_solve_sharded`` / ``preempt_rounds_sharded``, K15a-c), and the
final state's node planes are gathered back in the pass's one fetch.

A pass the kernel cannot express — the reference's host walk would strand
evictions on a node that cannot cover the request (``clean=False``) —
returns False with nothing recorded; the cycle then runs the object
preempt in its sub-cycle, or, if the reclaim pass holds records, takes the
object path for the whole cycle.  Each pass records the preemption
metrics (``scheduler/metrics.py``) as the JAX module does, and, while the
profiler is armed, its solve's dispatch and its one fetch
(``vtprof.device_get``, the whole-pass fetch boundary) under the phase
``reclaim`` or ``preempt``.

Divergences from the object path are the JAX module's: eviction-order ties
break by pod arrival rank rather than uid order, and job and queue
selection takes the exact lexicographic minimum of the session order keys
at each step.
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from volcano_tpu_torch import vtprof
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.scheduler import victim_kernels as VK

#: storms above this many preemptor tasks take the batched-rounds kernel
#: first (solve_mode "auto"; "batch" always does, "exact" never)
CONTENTION_BATCH_THRESHOLD = 64
#: the vtprof phase of each storm solve's dispatch and fetch
_PHASE = {"reclaim_solve": "reclaim", "preempt_solve": "preempt", "preempt_rounds": "preempt"}


def contention_static_args(conf, probe) -> dict:
    """The storm solves' policy flags, from the conf and the backend."""
    veto_p, veto_r = probe.victim_vetoes()
    return dict(
        kw_preempt=dict(
            use_gang="gang" in veto_p,
            use_drf="drf" in veto_p,
            use_conformance="conformance" in veto_p,
            order_by_priority=probe.task_order_by_priority,
        ),
        kw_reclaim=dict(
            use_gang="gang" in veto_r,
            use_prop="proportion" in veto_r,
            use_conformance="conformance" in veto_r,
            order_by_priority=probe.task_order_by_priority,
        ),
        gang_pipelined=any(
            opt.name == "gang" and opt.enabled_job_pipelined
            for tier in conf.tiers for opt in tier.plugins
        ),
        has_proportion=probe.enabled.get("proportion", False),
        job_key_order=tuple(probe.job_key_order),
    )


class FastContention:
    """One cycle's contention driver over the fast snapshot.  Build it after
    enqueue; run ``reclaim_pass`` before the allocate solve and
    ``preempt_pass`` after backfill (the conf's action order)."""

    def __init__(self, fc, snap, aux, deserved: np.ndarray):
        self.fc = fc
        self.snap = snap
        self.aux = aux
        self.device = fc.sched.device
        probe = fc.probe
        self.n_jobs = aux["n_jobs"]
        self.job_prio = snap.job_priority

        # host order-key state (the plugin attributes the object path keeps)
        self.occ = snap.job_ready_init.astype(np.int64).copy()
        self.pipe = np.zeros(self.occ.shape[0], np.int64)
        self.job_alloc = snap.job_alloc_init.astype(np.float64).copy()
        self.queue_alloc = snap.queue_alloc_init.astype(np.float64).copy()

        # committed decisions, published by the cycle at its end
        self.evictions: List[Tuple[int, str]] = []  # (pool index, reason)
        self.pipelines: List[Tuple[int, int]] = []  # (task row, node index)
        self.advanced = False  # advance_post_solve folded the solve in

        static = contention_static_args(fc.conf, probe)
        self.kw_preempt = static["kw_preempt"]
        self.kw_reclaim = static["kw_reclaim"]
        self.gang_pipelined = static["gang_pipelined"]
        self.has_proportion = static["has_proportion"]
        self.job_key_order = static["job_key_order"]

        # the conf mesh's blocks, or None for whole node planes
        self.mesh = probe.mesh if probe.victim_sharded() else None
        w_least, w_balanced = probe.score_weights()
        up, node = self._up, self._node
        self.consts = VK.VictimConsts(
            run_req=up(snap.run_req), run_node=up(snap.run_node),
            run_job=up(snap.run_job), run_prio=up(snap.run_prio),
            run_rank=up(snap.run_rank), run_evictable=up(snap.run_evictable),
            job_queue=up(snap.job_queue), job_min=up(snap.job_min_available),
            node_alloc=node(snap.node_alloc, "node_alloc"),
            node_max_tasks=node(snap.node_max_tasks, "node_max_tasks"),
            node_valid=node(snap.node_valid, "node_valid"),
            class_mask=node(snap.class_node_mask, "class_mask"),
            class_score=node(snap.class_node_score, "class_score"),
            queue_deserved=up(deserved.astype(np.float32)), total=up(snap.total),
            eps=up(snap.eps), w_least=float(np.float32(w_least)),
            w_balanced=float(np.float32(w_balanced)),
        )
        self.task_req_dev = up(snap.task_req)
        self.task_class_dev = up(snap.task_class)
        # the session state stays on the host between passes (copies:
        # fold_into_snapshot writes the snapshot arrays these start from)
        self.state = VK.VictimState(
            run_live=snap.run_valid.copy(), idle=snap.node_idle.copy(),
            releasing=snap.node_releasing.copy(), used=snap.node_used.copy(),
            task_count=snap.node_task_count.copy(), job_alloc=snap.job_alloc_init.copy(),
            job_occupied=snap.job_ready_init.copy(), queue_alloc=snap.queue_alloc_init.copy(),
        )

    def _up(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _node(self, arr, name: str):
        """A node plane on the device: whole, or this process's blocks of the
        mesh (``parallel/sharded.split_rows`` raises when they cannot divide
        the rows)."""
        t = self._up(arr)
        if self.mesh is None:
            return t
        from volcano_tpu_torch.parallel.sharded import split_rows

        return split_rows(self.mesh, name, t)

    def _state_dev(self) -> VK.VictimState:
        return VK.VictimState(*[self._node(x, f) if f in VK.STATE_NODE_PLANES else self._up(x)
                                for f, x in zip(VK.VictimState._fields, self.state)])

    def _solve(self, name: str, *args, **kw):
        """The pass's storm solve: on whole node planes, or the ``*_sharded``
        one on the mesh's blocks."""
        prof = vtprof.PROFILER
        t0 = time.perf_counter() if prof is not None else 0.0
        if self.mesh is None:
            out = getattr(VK, name)(*args, **kw)
        else:
            out = getattr(VK, name + "_sharded")(*args, self.mesh, **kw)
        if prof is not None:
            prof.dispatch_end(t0, self._kernel(name), phase=_PHASE[name])
        return out

    def _kernel(self, name: str) -> str:
        return name if self.mesh is None else name + "_sharded"

    # -- consts rebuild after a task re-pack --------------------------------

    def refresh_for_preempt(self, snap) -> None:
        """The task and class arrays were re-packed: the preempt pass reads
        the new class indexing."""
        self.consts = self.consts._replace(
            class_mask=self._node(snap.class_node_mask, "class_mask"),
            class_score=self._node(snap.class_node_score, "class_score"))
        self.task_req_dev = self._up(snap.task_req)
        self.task_class_dev = self._up(snap.task_class)

    def advance_post_solve(self, task_node, task_kind, ready, be_rows, be_nodes) -> None:
        """Fold the allocate solve's and backfill's effects into the victim
        state: allocations consume idle and count ready, pipelines consume
        releasing and count as pipelined, backfill placements count ready
        and take a task slot."""
        snap, aux = self.snap, self.aux
        idle = np.asarray(self.state.idle).copy()
        releasing = np.asarray(self.state.releasing).copy()
        used = np.asarray(self.state.used).copy()
        tc = np.asarray(self.state.task_count).copy()
        # the solve's own end-state ready counts (they fold in reclaim's
        # evictions through job_ready_init), plus backfill below
        self.occ = np.asarray(ready).astype(np.int64).copy()
        placed = np.nonzero(task_kind == 1)[0]
        piped = np.nonzero(task_kind == 2)[0]
        for rows, pool in ((placed, idle), (piped, releasing)):
            if not rows.size:
                continue
            np.subtract.at(pool, task_node[rows], snap.task_req[rows])
            np.add.at(used, task_node[rows], snap.task_req[rows])
            np.add.at(tc, task_node[rows], 1)
            jj = snap.task_job[rows]
            np.add.at(self.job_alloc, jj, snap.task_req[rows])
            np.add.at(self.queue_alloc, snap.job_queue[jj], snap.task_req[rows])
        if piped.size:
            np.add.at(self.pipe, snap.task_job[piped], 1)
        if be_rows.size:
            np.add.at(tc, be_nodes, 1)
            np.add.at(self.occ, aux["pod_j"][be_rows], 1)
        self.state = self.state._replace(
            idle=np.maximum(idle, 0.0).astype(np.float32),
            releasing=np.maximum(releasing, 0.0).astype(np.float32),
            used=used.astype(np.float32),
            task_count=tc.astype(np.int32),
            job_alloc=self.job_alloc.astype(np.float32),
            job_occupied=self.occ.astype(np.int32),
            queue_alloc=self.queue_alloc.astype(np.float32),
        )
        self.advanced = True

    # -- host plumbing around the storm kernels ------------------------------

    def _schedulable(self) -> np.ndarray:
        sched = np.zeros(self.snap.job_queue.shape[0], bool)
        sched[: self.n_jobs] = self.snap.job_schedulable[: self.n_jobs]
        return sched

    def _pend_per_job(self, key: str = "pend_nonbe_per_job") -> np.ndarray:
        J = self.snap.job_queue.shape[0]
        pend = np.zeros(J, np.int64)
        src = np.asarray(self.aux[key])
        n = min(J, src.shape[0])
        pend[:n] = src[:n]
        return pend

    def _absorb(self, state: Sequence[np.ndarray], pipe: np.ndarray) -> None:
        """Adopt a solve's final state and refresh the host order keys."""
        self.state = VK.VictimState(*state)
        self.pipe = pipe.astype(np.int64)
        self.occ = self.state.job_occupied.astype(np.int64)
        self.job_alloc = self.state.job_alloc.astype(np.float64)
        self.queue_alloc = self.state.queue_alloc.astype(np.float64)

    def _append_records(self, evict_att, pipe_node, pipe_att, reason: str) -> None:
        """Ordered decision lists from the per-row attempt sequences:
        preempt drains the reversed task order (priority asc, rank desc),
        reclaim evicts in pool order, each within its ok-attempt group."""
        snap = self.snap
        ev = np.nonzero(evict_att >= 0)[0]
        if ev.size:
            if reason == "reclaim":
                order = np.lexsort((ev, evict_att[ev]))
            elif self.kw_preempt["order_by_priority"]:
                order = np.lexsort((-snap.run_rank[ev], snap.run_prio[ev], evict_att[ev]))
            else:
                order = np.lexsort((-snap.run_rank[ev], evict_att[ev]))
            self.evictions.extend((int(i), reason) for i in ev[order])
        pt = np.nonzero(pipe_att >= 0)[0]
        for t in pt[np.argsort(pipe_att[pt], kind="stable")]:
            self.pipelines.append((int(t), int(pipe_node[t])))

    def _solve_fetch(self, name: str, out, extra: Sequence[torch.Tensor]):
        """The pass's one fetch (``vtprof.device_get``): final state (node
        planes gathered from the mesh's blocks), pipe, records, then
        ``extra``."""
        state = [self.mesh.gather_rows(torch.cat(x)) if isinstance(x, tuple) else x
                 for x in out.state]
        host = vtprof.device_get(
            state + [out.pipe, out.rec.evict_att, out.rec.pipe_node, out.rec.pipe_att]
            + list(extra), kernel=self._kernel(name), phase=_PHASE[name])
        n = len(VK.VictimState._fields)
        return host[:n], host[n], host[n + 1], host[n + 2], host[n + 3], host[n + 4:]

    # -- the passes ----------------------------------------------------------

    def reclaim_pass(self) -> bool:
        """reclaim.go:42-201 as one device program; False when the kernel
        met a case it cannot express (nothing recorded)."""
        snap = self.snap
        sched = self._schedulable()
        job_cand = sched & (self._pend_per_job() > 0)
        queue_live = np.zeros(snap.queue_alloc_init.shape[0], bool)
        qs = snap.job_queue[sched]
        qs = qs[qs >= 0]
        if qs.size:
            queue_live[qs] = True
        if not job_cand.any() or not queue_live.any():
            return True
        up = self._up
        out = self._solve(
            "reclaim_solve", self.consts, self._state_dev(), self.task_req_dev,
            self.task_class_dev,
            up(snap.job_start.astype(np.int32)), up(self.job_prio.astype(np.int32)),
            up(job_cand), up(queue_live), up(self.pipe.astype(np.int32)),
            has_proportion=self.has_proportion, job_key_order=self.job_key_order,
            **self.kw_reclaim,
        )
        state, pipe, ea, pn, pa, (abort,) = self._solve_fetch("reclaim_solve", out, [out.abort])
        if bool(abort):
            return False
        self._absorb(state, pipe)
        self._append_records(ea, pn, pa, "reclaim")
        return True

    def preempt_pass(self, placed_mask: np.ndarray) -> bool:
        """preempt.go:45-273 as one device program (the batched rounds
        first for a wide storm); False when the kernel met a case it cannot
        express (nothing of this pass recorded)."""
        snap = self.snap
        J = snap.job_queue.shape[0]
        T = snap.task_req.shape[0]
        sched = self._schedulable()
        attempt_rows = snap.task_valid & ~placed_mask
        unplaced = np.zeros(J, np.int64)
        if attempt_rows.any():
            unplaced = np.bincount(snap.task_job[attempt_rows], minlength=J)[:J]
        # any pending task (best-effort ones too) keeps a job a preemptor
        pend_ok = sched & (self._pend_per_job("pend_any_per_job") > 0)
        is_pre = pend_ok & (unplaced > 0)
        under = np.nonzero(is_pre)[0].astype(np.int32)
        nu = under.size
        # queues in first-appearance order over schedulable jobs
        jq = snap.job_queue[: self.n_jobs][snap.job_schedulable[: self.n_jobs]]
        jq = jq[jq >= 0]
        _, first = np.unique(jq, return_index=True)
        qorder = jq[np.sort(first)].astype(np.int32)
        nq = qorder.size
        if nu == 0 or nq == 0:
            return True
        Q = snap.queue_alloc_init.shape[0]
        under_pad = np.zeros(J, np.int32)
        under_pad[:nu] = under
        qpad = np.zeros(Q, np.int32)
        qpad[:nq] = qorder

        mode = self.fc.conf.solve_mode
        n_storm = int(unplaced[is_pre].sum())
        if mode == "batch" or (mode == "auto" and n_storm > CONTENTION_BATCH_THRESHOLD):
            # rounds-eligible jobs: a queue (a queueless commit would credit
            # queue 0), a remaining min-need within one round's window, and
            # no best-effort pending row (the rounds' capacity math has no
            # do-while eviction)
            need = np.maximum(snap.job_min_available.astype(np.int64) - self.occ - self.pipe, 0)
            be_jobs = np.zeros(J, bool)
            pe = self.aux["pe_rows"]
            n = min(T, pe.size)
            if n:
                is_be = np.zeros(T, bool)
                is_be[:n] = self.fc.mirror.p_best_effort[pe[:n]]
                rows_be = np.nonzero(is_be & snap.task_valid)[0]
                if rows_be.size:
                    be_jobs[np.unique(snap.task_job[rows_be])] = True
            eligible = (is_pre & (snap.job_queue >= 0) & (need <= VK.ROUNDS_P_CHUNK)
                        & ~be_jobs)
            if eligible.any():
                attempt_rows = self._rounds_stage(attempt_rows, eligible)
            left = attempt_rows & is_pre[snap.task_job] & snap.task_valid
            if not left.any():
                return True
            counts_left = np.bincount(snap.task_job[left], minlength=J)[:J]
            is_pre = pend_ok & (counts_left > 0)
            if not is_pre.any():
                return True
        up = self._up
        out = self._solve(
            "preempt_solve", self.consts, self._state_dev(), self.task_req_dev,
            self.task_class_dev,
            up(attempt_rows), up(snap.job_start.astype(np.int32)),
            up(snap.job_ntasks.astype(np.int32)), up(self.job_prio.astype(np.int32)),
            up(is_pre), up(under_pad), nu, up(qpad), nq, up(self.pipe.astype(np.int32)),
            job_key_order=self.job_key_order, gang_pipelined=self.gang_pipelined,
            **self.kw_preempt,
        )
        state, pipe, ea, pn, pa, (abort, att_total, last_v, any_p1) = self._solve_fetch(
            "preempt_solve", out, [out.abort, out.att_total, out.last_v, out.any_p1])
        if bool(abort):
            return False
        self._absorb(state, pipe)
        if bool(any_p1):
            metrics.update_preemption_victims(int(last_v))
        for _ in range(int(att_total)):
            metrics.register_preemption_attempt()
        self._append_records(ea, pn, pa, "preempt")
        return True

    def _rounds_stage(self, attempt_rows: np.ndarray, is_pre: np.ndarray) -> np.ndarray:
        """The batched rounds over the storm; returns the attemptable rows
        left for the exact tail.  Never aborts: rounds are capacity-safe,
        and what they cannot serve is left for the exact loop."""
        snap = self.snap
        J = snap.job_queue.shape[0]
        T = snap.task_req.shape[0]
        rows = np.nonzero(attempt_rows & is_pre[snap.task_job])[0]
        counts = np.bincount(snap.task_job[rows], minlength=J)[:J].astype(np.int32)
        pstart = np.zeros(J, np.int32)
        if J > 1:
            pstart[1:] = np.cumsum(counts[:-1]).astype(np.int32)
        rows_packed = np.zeros(T, np.int32)
        rows_packed[: rows.size] = rows
        up = self._up
        out = self._solve(
            "preempt_rounds", self.consts, self._state_dev(), self.task_req_dev,
            self.task_class_dev,
            up(rows_packed), up(pstart), up(counts), up(self.job_prio.astype(np.int32)),
            up(is_pre), up(self.pipe.astype(np.int32)),
            job_key_order=self.job_key_order, gang_pipelined=self.gang_pipelined,
            **self.kw_preempt,
        )
        state, pipe, ea, pn, pa, (att_total, last_v, any_commit) = self._solve_fetch(
            "preempt_rounds", out, [out.att_total, out.last_v, out.any_commit])
        if int(att_total) == 0:
            return attempt_rows
        self._absorb(state, pipe)
        if bool(any_commit):
            metrics.update_preemption_victims(int(last_v))
        for _ in range(int(att_total)):
            metrics.register_preemption_attempt()
        self._append_records(ea, pn, pa, "preempt")
        return attempt_rows & ~(pa >= 0)

    # -- integration back into the fast snapshot -----------------------------

    def fold_into_snapshot(self, m) -> None:
        """After the reclaim pass: write the state back into the snapshot
        arrays the allocate solve reads, and re-pack the task arrays without
        the pipelined reclaimers (the solves walk contiguous job rows)."""
        snap, aux = self.snap, self.aux
        st = self.state
        snap.node_idle[:] = st.idle
        snap.node_releasing[:] = st.releasing
        snap.node_used[:] = st.used
        snap.node_task_count[:] = st.task_count
        snap.job_alloc_init[:] = self.job_alloc.astype(np.float32)
        snap.queue_alloc_init[:] = self.queue_alloc.astype(np.float32)
        # evictions left the victims' jobs' ready counts
        snap.job_ready_init[:] = self.occ.astype(np.int32)
        if not self.pipelines:
            return
        consumed = np.asarray([t for t, _ in self.pipelines], np.int64)
        pe_rows = aux["pe_rows"]
        keep = np.setdiff1d(np.arange(pe_rows.size), consumed)
        _rebuild_task_arrays(m, self.fc, snap, aux, pe_rows[keep])
        self.refresh_for_preempt(snap)


def _rebuild_task_arrays(m, fc, snap, aux, new_pe_rows) -> None:
    """Re-pack the snapshot's task and class arrays over the surviving
    pending rows, at the cycle's task bucket."""
    from volcano_tpu_torch.scheduler.fastpath.snapshot_build import _task_arrays

    N, R = snap.node_idle.shape
    ta = _task_arrays(
        m, new_pe_rows, aux["pod_j"], aux["n_jobs"], N, R, aux["node_rows"],
        aux["n_nodes"], fc.nodeaffinity_weight, snap.job_start, snap.job_ntasks,
        min_T=snap.task_req.shape[0],
    )
    snap.task_req = ta["task_req"]
    snap.task_job = ta["task_job"]
    snap.task_class = ta["task_class"]
    snap.task_valid = ta["task_valid"]
    snap.class_node_mask = ta["class_mask"]
    snap.class_node_score = ta["class_score"]
    snap.task_uids = ta["pod_keys"]
    aux["pe_rows"] = new_pe_rows
    aux["n_tasks"] = ta["n_tasks"]

"""Tensor-backed actions and the allocate-solve dispatch.

The port's copy of ``volcano_tpu/scheduler/tensor_actions.py``:

* the solve dispatch with ONE device -> host fetch (under
  ``mesh_hosts > 1`` only this host's task block and the ready plane:
  ``_fetch_owned``): pick the exact or the
  batched solve, upload the snapshot, and let the solve write its four
  decision outputs into one int32 [3T + J] array (the layout of the JAX
  ``_packed_solve`` wrapper), which is the only thing the host copies
  back.  Under a conf mesh the batched solve runs on node blocks
  (``parallel/sharded.py``); the exact solve stays on one block.  The
  dynamic solve (host ports, pod (anti)affinity, volumes) runs the same
  kernels with the ``portsel`` extension over the dyn-expr jobs'
  tasks, and with the ``volsel`` extension when a task carries volume
  state, which forces the exact solve; the bitsets go up packed and are
  tested in place by the kernels;
* the object path's actions over a session's ``TensorBackend``:
  ``allocate`` (the solve, then its decisions replayed through the
  session, or applied in bulk above ``bulk_threshold`` placements; the
  dynamic-predicate jobs placed by the host afterwards), and ``preempt``
  and ``reclaim``, the host loops of the actions with each preemptor's
  victim search done by one ``victim_step`` (K7) and one fetch, or under
  a conf mesh with ``solve_mode="batch"`` by one ``victim_step_sharded``
  (K12b, the node planes in blocks) and one fetch.  The
  host fallbacks are part of the reference's semantics: the whole action
  on the host when the victim path cannot serve the session, and one
  preemptor on the host (then a resync) when the kernel reports that the
  reference's walk would strand evictions (``clean=False``) or the
  preemptor has no snapshot row (an empty request).
"""

from __future__ import annotations

import time

import numpy as np

from volcano_tpu_torch import trace, vtprof
from volcano_tpu_torch.api.types import PodGroupPhase, TaskStatus
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.scheduler.cache import VolumeBindingError
from volcano_tpu_torch.scheduler.kernels import (
    allocate_solve, allocate_solve_batch, pack_outputs, pack_volsel,
)
from volcano_tpu_torch.scheduler.pqueue import PriorityQueue
from volcano_tpu_torch.scheduler.statement import Statement
from volcano_tpu_torch.scheduler.victim_kernels import (
    unpack_step, victim_groups, victim_step, victim_step_sharded,
)


def use_batch_solve(backend, n_pending: int) -> bool:
    return backend.solve_mode == "batch" or (
        backend.solve_mode == "auto" and n_pending > backend.batch_threshold
    )


def _policy(backend):
    return dict(job_key_order=backend.job_key_order, use_gang_ready=backend.gang_job_ready,
                use_proportion=backend.proportion_queue_order)


def _one_block_call(backend, use_batch, inputs, task_words=None, volsel=None):
    """(solve, positional args, keyword args) of the exact or the batched
    solve on one block, from named inputs (``_SOLVE_ARGS`` names, and with
    K5 ``node_ports_w`` / ``node_selcnt``)."""
    from volcano_tpu_torch.scheduler.kernels import _SOLVE_ARGS

    kwargs = _policy(backend)
    if task_words is not None:
        tp, aff, anti, self_, w_podaff = task_words
        kwargs["portsel"] = (inputs["node_ports_w"], tp, inputs["node_selcnt"], aff, anti,
                             self_, w_podaff)
    if volsel is not None:
        kwargs["volsel"] = volsel
    solve = allocate_solve_batch if use_batch else allocate_solve
    return solve, [inputs[k] for k in _SOLVE_ARGS] + list(backend.score_weights()), kwargs


def _solve(backend, use_batch, inputs, task_words=None, volsel=None):
    """Run the exact or the batched solve on named inputs as placed by
    ``backend.placement_fn``: on the mesh's node blocks when the batched
    solve runs under a conf mesh, on one block otherwise."""
    if use_batch and backend.mesh is not None:
        from volcano_tpu_torch.parallel.sharded import _SPECS, sharded_solve
        from volcano_tpu_torch.scheduler.kernels import _SOLVE_ARGS

        planes = {k: v for k, v in inputs.items() if k in _SPECS}
        repl = {k: inputs[k] for k in _SOLVE_ARGS if k not in _SPECS}
        return sharded_solve(backend.mesh, planes, repl, *backend.score_weights(),
                             portsel_task=task_words, **_policy(backend))
    solve, args, kwargs = _one_block_call(backend, use_batch, inputs, task_words, volsel)
    return solve(*args, **kwargs)


def solve_inputs(backend, snap, use_batch):
    """The express solve's named inputs on the device, the node planes
    placed by ``backend.placement_fn(use_batch)``."""
    dev = backend.to_device
    devn = backend.placement_fn(use_batch)
    return dict(
        idle=devn(snap.node_idle, "idle"), releasing=devn(snap.node_releasing, "releasing"),
        used=devn(snap.node_used, "used"), node_alloc=devn(snap.node_alloc, "node_alloc"),
        node_max_tasks=devn(snap.node_max_tasks, "node_max_tasks"),
        task_count=devn(snap.node_task_count, "task_count"),
        node_valid=devn(snap.node_valid, "node_valid"),
        task_req=dev(snap.task_req), task_job=dev(snap.task_job),
        task_class=dev(snap.task_class), task_valid=dev(snap.task_valid),
        job_queue=dev(snap.job_queue), job_min=dev(snap.job_min_available),
        job_prio=dev(snap.job_priority), job_ready_init=dev(snap.job_ready_init),
        job_alloc_init=dev(snap.job_alloc_init), job_schedulable=dev(snap.job_schedulable),
        job_start=dev(snap.job_start), job_ntasks=dev(snap.job_ntasks),
        queue_alloc_init=dev(snap.queue_alloc_init), queue_deserved=backend.deserved(),
        class_mask=devn(snap.class_node_mask, "class_mask"),
        class_score=devn(snap.class_node_score, "class_score"),
        total=dev(snap.total), eps=dev(snap.eps),
    )


def _solve_kernel_name(use_batch: bool) -> str:
    return "allocate_solve_batch" if use_batch else "allocate_solve"


def torch_allocate_solve(backend, snap, n_pending=None):
    """Run the allocate solve for ``snap``; returns numpy (task_node,
    task_kind, task_seq, ready).  Armed, vtprof times the uploads and
    launches as the solve's dispatch and the fetch as its wait and
    transfer (phase ``solve``)."""
    if n_pending is None:
        n_pending = int(snap.task_valid.sum())
    use_batch = use_batch_solve(backend, n_pending)
    kname = _solve_kernel_name(use_batch)
    host = backend.mesh_host
    prof = vtprof.PROFILER
    t_disp = time.perf_counter() if prof is not None else 0.0
    out = _solve(backend, use_batch, solve_inputs(backend, snap, use_batch))
    if prof is not None:
        prof.dispatch_end(t_disp, kname, phase="solve")
    T, J = snap.task_req.shape[0], snap.job_queue.shape[0]
    if host is not None:
        if prof is not None:
            prof.note_mesh_host(host, dispatch_s=time.perf_counter() - t_disp)
        with trace.span("device.allocate_solve", batch=use_batch, mesh_host=int(host)) as sp:
            return _fetch_owned(out, T, J, host, backend.mesh_hosts, kname, sp)
    with trace.span("device.allocate_solve", batch=use_batch) as sp:
        return _fetch(out, T, J, kname, "solve", sp)


def _fetch_owned(out, T, J, host, n_hosts, kname, span):
    """The multi-controller fetch (JAX tensor_actions.py:522-590): only
    this host's task block of the three task planes, and the whole [J]
    ready plane every host needs for gang gating; rows outside the block
    are zero-filled (task_kind 0: not this host's to publish).  The
    per-host vtprof boundary: armed, its wall rolls up under the host's
    ``fetch_s``."""
    from volcano_tpu_torch.parallel.multihost import host_bounds

    packed = pack_outputs(out)
    lo, hi = host_bounds(T, n_hosts)[host]
    owned = vtprof.fetch_outputs(
        [packed[k * T + lo:k * T + hi] for k in range(3)] + [packed[3 * T:3 * T + J]],
        kernel=kname, phase="solve", host=host, span=span)

    def plane(vals):
        buf = np.zeros(T, np.int32)
        buf[lo:hi] = vals
        return buf

    return plane(owned[0]), plane(owned[1]), plane(owned[2]), owned[3]


def _fetch(out, T, J, kname, phase, span):
    """The one fetch boundary (``vtprof.fetch``): wait for the device, copy
    the packed array."""
    flat = vtprof.fetch(pack_outputs(out), kernel=kname, phase=phase, span=span)
    return (
        flat[:T], flat[T:2 * T], flat[2 * T:3 * T],
        np.ascontiguousarray(flat[3 * T:3 * T + J]),
    )


def dyn_solve_inputs(backend, snap, dyn, n_pending=None):
    """(use_batch, named inputs, K5 task words, volsel) of the dynamic solve
    for the dyn inputs ``dyn`` (``build_dyn_solve_inputs``), on the device:
    the same exact-or-batch rule as the express solve, except that volume
    state (``dyn["volsel"]``) is ordered and always takes the exact solve;
    the u32 words go up as int32 (bit-identical), the u16 selector counts
    as int32; under a conf mesh the batched solve's node planes (the
    resident port and selector planes too) go up as node blocks."""
    if n_pending is None:
        n_pending = int(dyn["task_valid"].sum())
    has_vol = dyn.get("volsel") is not None
    use_batch = not has_vol and use_batch_solve(backend, n_pending)
    dev = backend.to_device
    devn = backend.placement_fn(use_batch)

    def words(name):
        return dev(dyn[name].view(np.int32))

    inputs = dict(
        idle=devn(dyn["node_idle"], "idle"), releasing=devn(dyn["node_releasing"], "releasing"),
        used=devn(dyn["node_used"], "used"), node_alloc=devn(snap.node_alloc, "node_alloc"),
        node_max_tasks=devn(snap.node_max_tasks, "node_max_tasks"),
        task_count=devn(dyn["node_task_count"], "task_count"),
        node_valid=devn(snap.node_valid, "node_valid"),
        task_req=dev(dyn["task_req"]), task_job=dev(dyn["task_job"]),
        task_class=dev(dyn["task_class"]), task_valid=dev(dyn["task_valid"]),
        job_queue=dev(snap.job_queue), job_min=dev(snap.job_min_available),
        job_prio=dev(snap.job_priority), job_ready_init=dev(dyn["job_ready_init"]),
        job_alloc_init=dev(dyn["job_alloc_init"]),
        job_schedulable=dev(dyn["job_schedulable"]), job_start=dev(dyn["job_start"]),
        job_ntasks=dev(dyn["job_ntasks"]),
        queue_alloc_init=dev(dyn["queue_alloc_init"]), queue_deserved=backend.deserved(),
        class_mask=devn(dyn["class_mask"], "class_mask"),
        class_score=devn(dyn["class_score"], "class_score"),
        total=dev(snap.total), eps=dev(snap.eps),
        node_ports_w=devn(dyn["node_ports_w"].view(np.int32), "node_ports_w"),
        node_selcnt=devn(dyn["node_selcnt"].astype(np.int32), "node_selcnt"),
    )
    task_words = (words("task_ports_w"), words("task_aff_w"), words("task_anti_w"),
                  words("task_self_w"), backend.podaffinity_weight())
    volsel = tuple(dev(x) for x in pack_volsel(dyn["volsel"])) if has_vol else None
    return use_batch, inputs, task_words, volsel


def dyn_solve_args(backend, snap, dyn, n_pending=None):
    """(solve, positional args, keyword args) of the dynamic solve on one
    block (``allocate_solve`` or ``allocate_solve_batch`` with portsel and,
    for volume state, volsel)."""
    return _one_block_call(backend, *dyn_solve_inputs(backend, snap, dyn, n_pending))


def torch_dynamic_solve(backend, snap, dyn, n_pending=None):
    """Run the dynamic solve; returns numpy (task_node, task_kind,
    task_seq, ready) over the dyn task layout, in ONE packed fetch."""
    prof = vtprof.PROFILER
    t_disp = time.perf_counter() if prof is not None else 0.0
    use_batch, inputs, task_words, volsel = dyn_solve_inputs(backend, snap, dyn, n_pending)
    out = _solve(backend, use_batch, inputs, task_words, volsel)
    kname = "dynamic_" + _solve_kernel_name(use_batch)
    if prof is not None:
        prof.dispatch_end(t_disp, kname, phase="dyn_solve")
    with trace.span("device.dynamic_solve", batch=use_batch) as sp:
        return _fetch(out, dyn["task_req"].shape[0], snap.job_queue.shape[0], kname,
                      "dyn_solve", sp)


# --------------------------------------------------------------------------
# the object path's actions
# --------------------------------------------------------------------------

def _host_allocate(ssn) -> None:
    from volcano_tpu_torch.scheduler.actions.allocate import AllocateAction

    AllocateAction()._execute_host(ssn)


def _host_allocate_jobs(ssn, job_uids) -> None:
    """Host pass over the dynamic-predicate jobs, against session state
    already advanced by the device pass."""
    from volcano_tpu_torch.scheduler.actions.allocate import AllocateAction

    AllocateAction()._execute_host(ssn, job_filter=lambda job: job.uid in job_uids)


def _victim_path_usable(ssn, backend) -> bool:
    """Whether the victim kernel can serve this session: tensorizable
    tiers and class-expressible predicates."""
    if backend is None or not backend.supported:
        return False
    return not backend.snapshot.has_dynamic_predicates


class _VictimDriver:
    """Host loop control around victim_step: every device decision is
    replayed through the Statement/Session seams, so plugin event handlers
    and cache effects match the host path, while the victim search runs on
    the device."""

    def __init__(self, ssn, backend, veto_set, use_drf, use_prop):
        self.ssn = ssn
        self.backend = backend
        self.kw = dict(
            use_gang="gang" in veto_set,
            use_drf=use_drf and "drf" in veto_set,
            use_prop=use_prop and "proportion" in veto_set,
            use_conformance="conformance" in veto_set,
            order_by_priority=backend.task_order_by_priority,
        )
        self._load()

    def _load(self):
        # under a conf mesh with solveMode: batch the victim arrays' node
        # planes are node blocks and each attempt is one K12b solve
        self.mesh = self.backend.mesh if self.backend.victim_sharded() else None
        self.snap = snap = self.backend.snapshot
        self.consts, self.state = self.backend.victim_arrays()
        # the pool grouped by node once per snapshot: every attempt of this
        # load takes these groups (rows evicted later stay in them, skipped)
        self.groups = victim_groups(self.consts, self.state.run_live,
                                    order_by_priority=self.kw["order_by_priority"],
                                    mesh=self.mesh)
        self.task_req = self.backend.to_device(snap.task_req)
        self.task_row = {uid: i for i, uid in enumerate(snap.task_uids)}
        self.job_row = {uid: i for i, uid in enumerate(snap.job_uids)}
        self.queue_row = {name: i for i, name in enumerate(snap.queue_names)}

    def resync(self):
        """Rebuild the device state from the session after a host detour
        (the deserved shares stay frozen: the backend keeps them)."""
        self.backend.invalidate()
        self._load()

    def checkpoint(self):
        # neither solve writes its input state (blocked or not), so
        # references suffice
        return (self.snap, self.consts, self.groups, self.state, self.task_req, self.task_row,
                self.job_row, self.queue_row, self.mesh)

    def restore(self, ckpt):
        (self.snap, self.consts, self.groups, self.state, self.task_req, self.task_row,
         self.job_row, self.queue_row, self.mesh) = ckpt

    def attempt(self, task, mode):
        """Solve one preemptor: (assigned, node_name, victims, clean).  On a
        clean assignment the device state advances and the caller replays
        the decision; ``clean=False`` (the reference's walk would strand
        evictions, or the task has no snapshot row: an empty request) leaves
        the state untouched for the caller's host fallback."""
        t = self.task_row.get(task.uid)
        if t is None:
            return False, "", [], False
        snap = self.snap
        jt = self.job_row[task.job_uid]
        qt = self.queue_row.get(self.ssn.jobs[task.job_uid].queue, -1)
        prof = vtprof.PROFILER
        t_disp = time.perf_counter() if prof is not None else 0.0
        if self.mesh is None:
            kname = "victim_step"
            out = victim_step(self.consts, self.state, self.task_req[t],
                              int(snap.task_class[t]), jt, qt, mode=mode, groups=self.groups,
                              **self.kw)
        else:
            kname = "victim_step_sharded"
            out = victim_step_sharded(self.consts, self.state, self.task_req[t],
                                      int(snap.task_class[t]), jt, qt, self.mesh, mode=mode,
                                      groups=self.groups, **self.kw)
        phase = "reclaim" if mode == "reclaim" else "preempt"
        if prof is not None:
            prof.dispatch_end(t_disp, kname, phase=phase)
        # the one fetch of the attempt
        assigned, nstar, vmask, clean = unpack_step(
            vtprof.fetch(out.packed, kernel=kname, phase=phase), snap.run_req.shape[0])
        if not clean:
            return False, "", [], False
        if not assigned:
            return False, "", [], True
        self.state = out.state
        vidx = np.nonzero(vmask)[0]
        if mode == "reclaim":
            # reclaim evicts in candidate (insertion) order
            vidx = sorted(vidx)
        elif self.kw["order_by_priority"]:
            # preempt drains the reversed task-order queue: (prio asc, uid desc)
            vidx = sorted(vidx, key=lambda i: (snap.run_prio[i], -snap.run_rank[i]))
        else:
            vidx = sorted(vidx, key=lambda i: -snap.run_rank[i])
        victims = []
        for i in vidx:
            job_uid = snap.job_uids[snap.run_job[i]]
            victims.append(self.ssn.jobs[job_uid].tasks[snap.run_uids[i]].clone())
        return True, snap.node_names[nstar], victims, True


def _preemptors(ssn, with_queue_pq: bool):
    """The actions' shared set-up: per queue a job priority queue of the
    schedulable jobs with pending tasks, per job a task priority queue."""
    queues_pq = PriorityQueue(ssn.queue_order_fn) if with_queue_pq else None
    seen_queues = set()
    queues = {}
    preemptors_map = {}
    preemptor_tasks = {}
    under_request = []
    for job in ssn.jobs.values():
        if job.pod_group is not None and job.pod_group.status.phase == PodGroupPhase.PENDING:
            continue
        queue = ssn.queues.get(job.queue)
        if queue is None:
            continue
        queues.setdefault(queue.uid, queue)
        if queues_pq is not None and queue.uid not in seen_queues:
            seen_queues.add(queue.uid)
            queues_pq.push(queue)
        if job.task_status_index.get(TaskStatus.PENDING):
            if job.queue not in preemptors_map:
                preemptors_map[job.queue] = PriorityQueue(ssn.job_order_fn)
            preemptors_map[job.queue].push(job)
            under_request.append(job)
            tasks = PriorityQueue(ssn.task_order_fn)
            for task in job.task_status_index[TaskStatus.PENDING].values():
                tasks.push(task)
            preemptor_tasks[job.uid] = tasks
    return queues_pq, queues, preemptors_map, preemptor_tasks, under_request


def preempt(ssn) -> None:
    """preempt.go's loops with the per-node victim collection replaced by
    one victim_step per preemptor."""
    from volcano_tpu_torch.scheduler.actions.preempt import PreemptAction, _preempt

    backend = ssn.tensor_backend
    if not _victim_path_usable(ssn, backend):
        PreemptAction()._execute_host(ssn)
        if backend is not None:
            backend.invalidate()  # the host path mutated state behind the snapshot
        return

    veto_p, _ = backend.victim_vetoes()
    driver = _VictimDriver(ssn, backend, veto_p, use_drf=True, use_prop=False)

    def host_attempt(stmt, preemptor, task_filter):
        ok = _preempt(ssn, stmt, preemptor, task_filter)
        driver.resync()
        return ok

    _, queues, preemptors_map, preemptor_tasks, under_request = _preemptors(ssn, False)
    for queue in queues.values():
        while True:
            preemptors = preemptors_map.get(queue.uid)
            if preemptors is None or preemptors.empty():
                break
            preemptor_job = preemptors.pop()
            stmt = Statement(ssn)
            ckpt = driver.checkpoint()
            assigned = False
            while True:
                if preemptor_tasks[preemptor_job.uid].empty():
                    break
                preemptor = preemptor_tasks[preemptor_job.uid].pop()
                ok, node_name, victims, clean = driver.attempt(preemptor, "queue")
                if not clean:
                    def job_filter(task, _job=preemptor_job, _p=preemptor):
                        if task.status != TaskStatus.RUNNING:
                            return False
                        j = ssn.jobs.get(task.job_uid)
                        return (j is not None and j.queue == _job.queue
                                and _p.job_uid != task.job_uid)

                    ok = host_attempt(stmt, preemptor, job_filter)
                elif ok:
                    for v in victims:
                        stmt.evict(v, "preempt")
                    stmt.pipeline(preemptor, node_name)
                    metrics.update_preemption_victims(len(victims))
                    metrics.register_preemption_attempt()
                if ok:
                    assigned = True
                if ssn.job_pipelined(preemptor_job):
                    break
            if ssn.job_pipelined(preemptor_job):
                stmt.commit()
            else:
                stmt.discard()
                driver.restore(ckpt)
                continue
            if assigned:
                preemptors.push(preemptor_job)

        # phase 2: task-level preemption within each job
        for job in under_request:
            while True:
                tasks = preemptor_tasks.get(job.uid)
                if tasks is None or tasks.empty():
                    break
                preemptor = tasks.pop()
                stmt = Statement(ssn)
                ok, node_name, victims, clean = driver.attempt(preemptor, "job")
                if not clean:
                    def task_filter(task, _p=preemptor):
                        return task.status == TaskStatus.RUNNING and _p.job_uid == task.job_uid

                    ok = host_attempt(stmt, preemptor, task_filter)
                elif ok:
                    for v in victims:
                        stmt.evict(v, "preempt")
                    stmt.pipeline(preemptor, node_name)
                    metrics.register_preemption_attempt()
                stmt.commit()
                if not ok:
                    break
    backend.invalidate()


def reclaim(ssn) -> None:
    """reclaim.go's loop with the per-node victim collection replaced by
    one victim_step per reclaimer."""
    from volcano_tpu_torch.scheduler.actions.reclaim import ReclaimAction, reclaim_task

    backend = ssn.tensor_backend
    if not _victim_path_usable(ssn, backend):
        ReclaimAction()._execute_host(ssn)
        if backend is not None:
            backend.invalidate()
        return

    _, veto_r = backend.victim_vetoes()
    driver = _VictimDriver(ssn, backend, veto_r, use_drf=False, use_prop=True)
    queues, _, preemptors_map, preemptor_tasks, _ = _preemptors(ssn, True)
    while not queues.empty():
        queue = queues.pop()
        if ssn.overused(queue):
            continue
        jobs = preemptors_map.get(queue.uid)
        if jobs is None or jobs.empty():
            continue
        job = jobs.pop()
        tasks = preemptor_tasks.get(job.uid)
        if tasks is None or tasks.empty():
            continue
        task = tasks.pop()
        ok, node_name, victims, clean = driver.attempt(task, "reclaim")
        if not clean:
            ok = reclaim_task(ssn, job, task)
            driver.resync()
        elif ok:
            for v in victims:
                ssn.evict(v, "reclaim")
            ssn.pipeline(task, node_name)
        if ok:
            queues.push(queue)
    backend.invalidate()


def allocate(ssn) -> None:
    backend = ssn.tensor_backend
    if backend is None or not backend.supported:
        _host_allocate(ssn)
        return
    snap = backend.snapshot
    # dynamic-predicate jobs were partitioned out of the task arrays; the
    # host places them after the device pass
    residue = set(snap.dynamic_job_uids)
    if residue and (snap.partition_unsafe or not np.any(snap.task_valid)):
        # a dynamic job outranks an express job of its queue, or nothing is
        # expressible: the exact host path for the whole action
        _host_allocate(ssn)
        backend.invalidate()
        return

    task_node, task_kind, task_seq, ready = torch_allocate_solve(backend, snap)
    placed = np.nonzero(task_kind > 0)[0]
    _set_fit_error_fns(ssn, snap, task_node, task_kind, placed)
    if not placed.size and not residue:
        return  # nothing changed: later actions keep the snapshot
    if placed.size:
        order = placed[np.argsort(task_seq[placed])]
        # the bulk path skips per-task allocate events, sound only for the
        # plugins whose accounting the solve models (drf, proportion)
        foreign_handlers = any(eh.owner not in ("drf", "proportion")
                               for eh in ssn.event_handlers)
        if placed.size <= backend.bulk_threshold or foreign_handlers:
            _replay_exact(ssn, snap, order, task_node, task_kind)
        else:
            _apply_bulk(ssn, snap, order, task_node, task_kind, ready,
                        use_gang=backend.gang_job_ready, account_nodes=bool(residue))
            if residue:
                ssn.resync_plugin_shares()
    if residue:
        _host_allocate_jobs(ssn, residue)
    backend.invalidate()


def _set_fit_error_fns(ssn, snap, task_node, task_kind, placed) -> None:
    """Attach a lazy fit-error histogram producer to every job the solve
    left with unplaced pending tasks, so gang's close-time condition renders
    the host path's "0/N nodes are available, ..." aggregate."""
    unplaced = np.nonzero(snap.task_valid & (task_kind == 0))[0]
    if not unplaced.size:
        return
    # allocations consume idle; pipelines consume releasing space
    alloc_rows = placed[task_kind[placed] == 1]
    idle_after = snap.node_idle.copy()
    if alloc_rows.size:
        np.subtract.at(idle_after, task_node[alloc_rows], snap.task_req[alloc_rows])
    seen = set()
    for t in unplaced:
        j = int(snap.task_job[t])
        if j in seen:
            continue
        seen.add(j)
        job = ssn.jobs.get(snap.job_uids[j])
        if job is not None:
            job.fit_error_fn = _fit_error_producer(snap, idle_after, int(t))


def _fit_error_producer(snap, idle_after, t):
    def produce():
        valid = snap.node_valid.astype(bool)
        total = int(valid.sum())
        mask = snap.class_node_mask[int(snap.task_class[t])].astype(bool) & valid
        reasons = {}
        excluded = total - int(mask.sum())
        if excluded:
            reasons["node(s) excluded by predicates"] = excluded
        insufficient = idle_after < snap.task_req[t][None, :]
        for r, dim in enumerate(snap.dims):
            count = int((insufficient[:, r] & mask).sum())
            if count:
                reasons[f"insufficient {dim}"] = count
        return total, reasons

    return produce


def _replay_exact(ssn, snap, order, task_node, task_kind) -> None:
    """Each decision through Session.allocate/pipeline in solve order: the
    host path's side effects (events, dispatch, binds)."""
    for t in order:
        job = ssn.jobs.get(snap.job_uids[snap.task_job[t]])
        if job is None:
            continue
        task = job.tasks[snap.task_uids[t]]
        node_name = snap.node_names[task_node[t]]
        if task_kind[t] == 1:
            try:
                ssn.allocate(task, node_name)
            except VolumeBindingError:
                continue  # volume state changed under the solve: stays pending
        else:
            ssn.pipeline(task, node_name)


def _apply_bulk(ssn, snap, order, task_node, task_kind, ready,
                use_gang=True, account_nodes=False) -> None:
    """Bulk application: binds go to the cache for the allocated tasks of
    gang-ready jobs (every job counts as ready without gang's JobReady);
    task statuses move on the session's jobs, so close_session writes the
    right PodGroup statuses, and job allocations add up in solve order, as
    the per-task status updates do.  Plugin event handlers do not fire (the
    solve accounted the shares).  ``account_nodes`` charges the placements
    to the NodeInfo objects too, for a host pass that reads them after."""
    if use_gang:
        ready_jobs = {snap.job_uids[j] for j in range(len(snap.job_uids))
                      if ready[j] >= snap.job_min_available[j]}
    else:
        ready_jobs = set(snap.job_uids)
    for t in order:
        job_uid = snap.job_uids[snap.task_job[t]]
        job = ssn.jobs.get(job_uid)
        if job is None:
            continue
        task = job.tasks[snap.task_uids[t]]
        node_name = snap.node_names[task_node[t]]
        task.node_name = node_name
        if task_kind[t] == 1:
            if job_uid in ready_jobs:
                if task.pod is not None and task.pod.volumes:
                    try:
                        ssn.cache.allocate_volumes(task.pod, node_name)
                        ssn.cache.bind_volumes(task.pod)
                    except VolumeBindingError:
                        job.update_task_status(task, TaskStatus.ALLOCATED)
                        continue
                ssn.cache.bind(task, node_name)
                job.update_task_status(task, TaskStatus.BINDING)
            else:
                job.update_task_status(task, TaskStatus.ALLOCATED)
        else:
            job.update_task_status(task, TaskStatus.PIPELINED)
        if account_nodes:
            ssn.nodes[node_name].add_task(task)

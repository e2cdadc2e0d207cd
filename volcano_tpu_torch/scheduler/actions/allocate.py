"""Allocate action: the per-cycle loop assigning pending tasks to nodes
(the port's copy of ``volcano_tpu/scheduler/actions/allocate.py``).

Loop shape:
  * queues in a priority queue by QueueOrderFn; each outer iteration pops the
    best queue, skips it if Overused, and processes ONE job from it;
  * a job's pending non-BestEffort tasks drain in TaskOrderFn order until the
    head task has no feasible node (drop job this cycle) or the job becomes
    JobReady (push it back so remaining tasks continue next pop);
  * per task: resource-fit + plugin predicates filter nodes, NodeOrderFn
    scores them, the best node takes the task — Allocate on idle fit,
    Pipeline on releasing fit;
  * the queue is pushed back every iteration.

With a tensor backend on the session the whole loop is the device solve
(``tensor_actions.allocate``), its decisions replayed through the same
Session.allocate/pipeline seams.  A filtered pass (``job_filter``, the fast
cycle's object sub-cycle) runs the vectorized residue engine
(``scheduler/residue.py``): the same ``allocate_loop`` with the inner step
batched over the nodes, bit for bit this loop's placements.  The unfiltered
pass keeps the per-task step below as the oracle.
"""

from __future__ import annotations

from volcano_tpu_torch.api.types import PodGroupPhase, TaskStatus
from volcano_tpu_torch.scheduler import util
from volcano_tpu_torch.scheduler.cache import VolumeBindingError
from volcano_tpu_torch.scheduler.framework import Action
from volcano_tpu_torch.scheduler.pqueue import PriorityQueue
from volcano_tpu_torch.scheduler.session import Session


def _fit_failure_reason(task, node) -> str:
    """Canonical per-dimension resource-fit failure, "; "-joined so
    util.predicate_nodes histograms each insufficient dimension separately
    (the job_info.go:345-357 reason scheme)."""
    req, idle = task.init_resreq, node.idle
    dims = []
    if req.milli_cpu > idle.milli_cpu:
        dims.append("insufficient cpu")
    if req.memory > idle.memory:
        dims.append("insufficient memory")
    for name, v in req.scalars.items():
        if v > idle.scalars.get(name, 0.0):
            dims.append(f"insufficient {name}")
    return "; ".join(dims) or "insufficient resources"


def fit_first_predicate_fn(ssn):
    """Allocate's per-node check: resource fit first — idle OR releasing
    (allocate.go:78-93) — then the session predicate chain.  ONE
    definition for every caller, so their unschedulable-head reason
    histograms cannot drift apart."""

    def predicate_fn(task, node):
        if not (
            task.init_resreq.less_equal(node.idle)
            or task.init_resreq.less_equal(node.releasing)
        ):
            return _fit_failure_reason(task, node)
        return ssn.predicate_fn(task, node)

    return predicate_fn


def allocate_loop(ssn: Session, job_filter, inner) -> None:
    """The allocate action's queue/job/task selection skeleton
    (allocate.go:44-193); the per-task ``inner`` step places one task.

    Ordering note: the reference holds queues/jobs in lazy binary heaps
    whose comparisons see mutating DRF/proportion shares only at sift
    time, so its pop order is a stale approximation of the share
    ordering.  Both inner steps here re-select the exact best queue/job
    each iteration instead — same loop, exact ordering (first-minimum on
    ties, matching the kernel's argmin).

    ``inner(job, task) -> bool``: place one task with every session side
    effect (allocate/pipeline/fit-delta/fit-error bookkeeping); False
    means the head task had no feasible node — the job drops for this
    cycle (allocate.go:151)."""
    jobs_by_queue = {}

    for job in sorted(ssn.jobs.values(), key=lambda j: j.creation_order):
        if (
            job.pod_group is not None
            and job.pod_group.status.phase == PodGroupPhase.PENDING
        ):
            continue
        if job_filter is not None and not job_filter(job):
            continue
        queue = ssn.queues.get(job.queue)
        if queue is None:
            continue
        jobs_by_queue.setdefault(queue.uid, []).append(job)

    pending_tasks = {}
    dropped_queues = set()
    queue_order = sorted(ssn.queues.values(), key=lambda q: q.uid)

    def job_tasks(job):
        if job.uid not in pending_tasks:
            tasks = PriorityQueue(ssn.task_order_fn)
            for task in job.task_status_index.get(TaskStatus.PENDING, {}).values():
                if task.resreq.is_empty():
                    continue  # BestEffort handled by backfill
                tasks.push(task)
            pending_tasks[job.uid] = tasks
        return pending_tasks[job.uid]

    def first_min(items, less):
        best = None
        for x in items:
            if best is None or less(x, best):
                best = x
        return best

    # drained jobs are pruned from jobs_by_queue as they're discovered so
    # re-selection cost shrinks as the cycle progresses
    cur_job = None
    while True:
        if cur_job is None:
            for q_uid, jobs in list(jobs_by_queue.items()):
                live = [j for j in jobs if not job_tasks(j).empty()]
                if live:
                    jobs_by_queue[q_uid] = live
                else:
                    del jobs_by_queue[q_uid]
            candidates = [
                q
                for q in queue_order
                if q.uid not in dropped_queues and jobs_by_queue.get(q.uid)
            ]
            if not candidates:
                break
            queue = first_min(candidates, ssn.queue_order_fn)
            if ssn.overused(queue):
                dropped_queues.add(queue.uid)
                continue
            cur_job = first_min(jobs_by_queue[queue.uid], ssn.job_order_fn)
            continue

        job = cur_job
        tasks = job_tasks(job)
        task = tasks.pop()

        if job.nodes_fit_delta:
            job.nodes_fit_delta = {}

        if not inner(job, task):
            # head task unschedulable: drop the job for this cycle
            jobs_by_queue[job.queue] = [
                j for j in jobs_by_queue.get(job.queue, ()) if j.uid != job.uid
            ]
            if not jobs_by_queue[job.queue]:
                del jobs_by_queue[job.queue]
            cur_job = None
            continue

        if ssn.job_ready(job) or tasks.empty():
            cur_job = None


class AllocateAction(Action):
    name = "allocate"

    def execute(self, ssn: Session) -> None:
        if ssn.tensor_backend is not None:
            from volcano_tpu_torch.scheduler import tensor_actions

            tensor_actions.allocate(ssn)
            return
        self._execute_host(ssn)

    def _execute_host(self, ssn: Session, job_filter=None, vectorized=None,
                      stats=None) -> None:
        # ``job_filter`` restricts the pass to a job subset: the residue
        # jobs of the fast cycle (scheduler.run_object_residue), or the
        # dynamic-predicate jobs after a device solve
        # (tensor_actions._host_allocate_jobs).  A filtered pass takes the
        # vectorized engine; the unfiltered one keeps the per-task step as
        # the oracle.  ``vectorized`` forces the choice (tests); ``stats``
        # gathers the engine's {"tasks", "seconds"} for the residue_vec phase
        if vectorized is None:
            vectorized = job_filter is not None
        if vectorized:
            from volcano_tpu_torch.scheduler import residue

            if residue.vector_allocate(ssn, job_filter, stats=stats):
                return
        all_nodes = util.get_node_list(ssn.nodes)
        predicate_fn = fit_first_predicate_fn(ssn)

        def inner(job, task):
            reasons: dict = {}
            feasible = util.predicate_nodes(
                task, all_nodes, predicate_fn, reasons
            )
            if not feasible:
                # record the reason histogram for fit_error() reporting
                job.fit_errors = reasons
                job.fit_total_nodes = len(all_nodes)
                return False

            scores = util.prioritize_nodes(task, feasible, ssn.node_order_fn)
            node = util.select_best_node(scores)

            if task.init_resreq.less_equal(node.idle):
                try:
                    ssn.allocate(task, node.name)
                except VolumeBindingError:
                    # volume state changed between predicate and allocate
                    # (another task claimed the PV); task stays pending
                    # (reference: AllocateVolumes error skips the task,
                    # session.go:239-244)
                    pass
            else:
                delta = node.idle.clone()
                delta.fit_delta(task.init_resreq)
                job.nodes_fit_delta[node.name] = delta
                job.fit_total_nodes = len(all_nodes)
                if task.init_resreq.less_equal(node.releasing):
                    ssn.pipeline(task, node.name)
            return True

        allocate_loop(ssn, job_filter, inner)

"""Preempt action: within-queue preemption for starved high-priority jobs
(the port's copy of ``volcano_tpu/scheduler/actions/preempt.py``).

Phase 1: per queue, each job with pending tasks opens a Statement, collects
Running same-queue victims of other jobs via ssn.preemptable, evicts lowest
task-order first until the preemptor's request is covered, pipelines the
preemptor; Commit when the job reaches JobPipelined, else Discard (atomic
gang preemption). Phase 2: task-level preemption within each job.
"""

from __future__ import annotations

from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import PodGroupPhase, TaskStatus
from volcano_tpu_torch.scheduler import metrics, util
from volcano_tpu_torch.scheduler.framework import Action
from volcano_tpu_torch.scheduler.pqueue import PriorityQueue
from volcano_tpu_torch.scheduler.session import Session
from volcano_tpu_torch.scheduler.statement import Statement


class PreemptAction(Action):
    name = "preempt"

    def execute(self, ssn: Session) -> None:
        if ssn.tensor_backend is not None:
            from volcano_tpu_torch.scheduler import tensor_actions

            tensor_actions.preempt(ssn)
            return
        self._execute_host(ssn)

    def _execute_host(self, ssn: Session) -> None:
        preemptors_map = {}
        preemptor_tasks = {}
        under_request = []
        queues = {}

        for job in ssn.jobs.values():
            if (
                job.pod_group is not None
                and job.pod_group.status.phase == PodGroupPhase.PENDING
            ):
                continue
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            queues.setdefault(queue.uid, queue)

            if job.task_status_index.get(TaskStatus.PENDING):
                if job.queue not in preemptors_map:
                    preemptors_map[job.queue] = PriorityQueue(ssn.job_order_fn)
                preemptors_map[job.queue].push(job)
                under_request.append(job)
                tasks = PriorityQueue(ssn.task_order_fn)
                for task in job.task_status_index[TaskStatus.PENDING].values():
                    tasks.push(task)
                preemptor_tasks[job.uid] = tasks

        for queue in queues.values():
            # Phase 1: preemption between jobs within the queue.
            while True:
                preemptors = preemptors_map.get(queue.uid)
                if preemptors is None or preemptors.empty():
                    break
                preemptor_job = preemptors.pop()

                stmt = Statement(ssn)
                assigned = False
                while True:
                    if preemptor_tasks[preemptor_job.uid].empty():
                        break
                    preemptor = preemptor_tasks[preemptor_job.uid].pop()

                    def job_filter(task):
                        if task.status != TaskStatus.RUNNING:
                            return False
                        j = ssn.jobs.get(task.job_uid)
                        if j is None:
                            return False
                        return (
                            j.queue == preemptor_job.queue
                            and preemptor.job_uid != task.job_uid
                        )

                    if _preempt(ssn, stmt, preemptor, job_filter):
                        assigned = True

                    if ssn.job_pipelined(preemptor_job):
                        break

                # settle the statement on EVERY path out of the task loop
                # (the reference commits inside the loop, preempt.go:132;
                # equivalent — nothing runs between its commit and the
                # break — and this shape is provably commit-or-discard)
                if ssn.job_pipelined(preemptor_job):
                    stmt.commit()
                else:
                    stmt.discard()
                    continue

                if assigned:
                    preemptors.push(preemptor_job)

            # Phase 2: preemption between tasks within one job.
            for job in under_request:
                while True:
                    tasks = preemptor_tasks.get(job.uid)
                    if tasks is None or tasks.empty():
                        break
                    preemptor = tasks.pop()

                    def task_filter(task):
                        return (
                            task.status == TaskStatus.RUNNING
                            and preemptor.job_uid == task.job_uid
                        )

                    stmt = Statement(ssn)
                    assigned = _preempt(ssn, stmt, preemptor, task_filter)
                    stmt.commit()
                    if not assigned:
                        break


def _preempt(ssn: Session, stmt: Statement, preemptor, task_filter) -> bool:
    assigned = False
    all_nodes = util.get_node_list(ssn.nodes)
    feasible = util.predicate_nodes(preemptor, all_nodes, ssn.predicate_fn)
    scores = util.prioritize_nodes(preemptor, feasible, ssn.node_order_fn)

    for node in util.sort_nodes(scores):
        preemptees = [
            task.clone() for task in node.tasks.values() if task_filter(task)
        ]
        victims = ssn.preemptable(preemptor, preemptees)
        metrics.update_preemption_victims(len(victims or []))

        if not victims:
            continue
        # feasibility: total victim resources must cover the request
        # (validateVictims, preempt.go:245-262 — uses the quirky strict Less)
        all_res = Resource()
        for v in victims:
            all_res.add(v.resreq)
        if all_res.less(preemptor.init_resreq):
            continue

        # evict lowest task-order first (reverse TaskOrderFn queue)
        victims_queue = PriorityQueue(lambda l, r: not ssn.task_order_fn(l, r))
        for v in victims:
            victims_queue.push(v)

        preempted = Resource()
        resreq = preemptor.init_resreq.clone()
        while not victims_queue.empty():
            preemptee = victims_queue.pop()
            stmt.evict(preemptee, "preempt")
            preempted.add(preemptee.resreq)
            if resreq.less_equal(preempted):
                break

        metrics.register_preemption_attempt()

        if preemptor.init_resreq.less_equal(preempted):
            stmt.pipeline(preemptor, node.name)
            assigned = True
            break

    return assigned

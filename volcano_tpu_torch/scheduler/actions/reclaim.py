"""Reclaim action: cross-queue eviction to restore weighted fair shares (the
port's copy of ``volcano_tpu/scheduler/actions/reclaim.py``).

Per non-overused queue, the head pending task collects Running tasks of
*other* queues per node, filters them through ssn.reclaimable (proportion
keeps queues at/above deserved; gang protects minAvailable), evicts until
the request is covered, then pipelines the reclaimer.
"""

from __future__ import annotations

from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import PodGroupPhase, TaskStatus
from volcano_tpu_torch.scheduler.framework import Action
from volcano_tpu_torch.scheduler.pqueue import PriorityQueue
from volcano_tpu_torch.scheduler.session import Session


class ReclaimAction(Action):
    name = "reclaim"

    def execute(self, ssn: Session) -> None:
        if ssn.tensor_backend is not None:
            from volcano_tpu_torch.scheduler import tensor_actions

            tensor_actions.reclaim(ssn)
            return
        self._execute_host(ssn)

    def _execute_host(self, ssn: Session) -> None:
        queues = PriorityQueue(ssn.queue_order_fn)
        seen_queues = set()
        preemptors_map = {}
        preemptor_tasks = {}

        for job in ssn.jobs.values():
            if (
                job.pod_group is not None
                and job.pod_group.status.phase == PodGroupPhase.PENDING
            ):
                continue
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            if queue.uid not in seen_queues:
                seen_queues.add(queue.uid)
                queues.push(queue)

            if job.task_status_index.get(TaskStatus.PENDING):
                if job.queue not in preemptors_map:
                    preemptors_map[job.queue] = PriorityQueue(ssn.job_order_fn)
                preemptors_map[job.queue].push(job)
                tasks = PriorityQueue(ssn.task_order_fn)
                for task in job.task_status_index[TaskStatus.PENDING].values():
                    tasks.push(task)
                preemptor_tasks[job.uid] = tasks

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

            if reclaim_task(ssn, job, task):
                queues.push(queue)


def reclaim_task(ssn: Session, job, task) -> bool:
    """Walk nodes in snapshot order reclaiming other-queue residents for
    one pending task (the inner loop of reclaim.go:115-180). Shared by the
    host action and the tensor driver's rare-path fallback."""
    for node in ssn.nodes.values():
        if ssn.predicate_fn(task, node) is not None:
            continue

        reclaimees = []
        for resident in node.tasks.values():
            if resident.status != TaskStatus.RUNNING:
                continue
            j = ssn.jobs.get(resident.job_uid)
            if j is None or j.queue == job.queue:
                continue
            reclaimees.append(resident.clone())

        victims = ssn.reclaimable(task, reclaimees)
        if not victims:
            continue

        all_res = Resource()
        for v in victims:
            all_res.add(v.resreq)
        if all_res.less(task.init_resreq):
            continue

        reclaimed = Resource()
        resreq = task.init_resreq.clone()
        for reclaimee in victims:
            ssn.evict(reclaimee, "reclaim")
            reclaimed.add(reclaimee.resreq)
            if resreq.less_equal(reclaimed):
                break

        if task.init_resreq.less_equal(reclaimed):
            ssn.pipeline(task, node.name)
            return True

    return False

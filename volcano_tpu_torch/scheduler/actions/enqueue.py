"""Enqueue action: admit Pending PodGroups into the cluster when idle
capacity (with 1.2x overcommit) covers their MinResources (the port's copy
of ``volcano_tpu/scheduler/actions/enqueue.py``).
"""

from __future__ import annotations

from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import PodGroupPhase, TaskStatus
from volcano_tpu_torch.scheduler.framework import Action
from volcano_tpu_torch.scheduler.pqueue import PriorityQueue
from volcano_tpu_torch.scheduler.session import Session

OVERCOMMIT_FACTOR = 1.2  # enqueue.go:80


class EnqueueAction(Action):
    name = "enqueue"

    def execute(self, ssn: Session) -> None:
        queues = PriorityQueue(ssn.queue_order_fn)
        seen_queues = set()
        jobs_map = {}

        for job in ssn.jobs.values():
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            if queue.uid not in seen_queues:
                seen_queues.add(queue.uid)
                queues.push(queue)
            if (
                job.pod_group is not None
                and job.pod_group.status.phase == PodGroupPhase.PENDING
            ):
                if job.queue not in jobs_map:
                    jobs_map[job.queue] = PriorityQueue(ssn.job_order_fn)
                jobs_map[job.queue].push(job)

        from volcano_tpu_torch.scheduler.model import _sub_clamped

        idle = Resource()
        for node in ssn.nodes.values():
            overcommitted = node.allocatable.clone().multi(OVERCOMMIT_FACTOR)
            # clamp per-node: an oversubscribed node (allocatable shrank
            # below usage) contributes zero, not a crash — the reference's
            # Sub would panic here (enqueue.go:80)
            _sub_clamped(overcommitted, node.used, Resource())
            idle.add(overcommitted)

        empty = Resource()
        while not queues.empty():
            if idle.less(empty):
                break
            queue = queues.pop()
            jobs = jobs_map.get(queue.uid)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()

            inqueue = False
            if job.task_status_index.get(TaskStatus.PENDING):
                inqueue = True
            elif job.pod_group.min_resources.is_empty():
                inqueue = True
            else:
                pg_resource = job.pod_group.min_resources.clone()
                if pg_resource.less_equal(idle):
                    idle.sub(pg_resource)
                    inqueue = True

            if inqueue:
                job.pod_group.status.phase = PodGroupPhase.INQUEUE

            queues.push(queue)

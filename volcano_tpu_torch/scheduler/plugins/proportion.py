"""Proportion plugin: weighted fair queue shares via iterative water-filling
(the port's copy of ``volcano_tpu/scheduler/plugins/proportion.py``).

Each round, unmet queues split the remaining cluster resources by weight;
a queue whose deserved reaches its request is capped and marked met; repeat
until nothing remains. QueueOrder by share = max_r allocated/deserved;
Overused when deserved <= allocated (epsilon-tolerant); reclaim victims only
while the victim's queue stays at/above its deserved share.
"""

from __future__ import annotations

from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import TaskStatus, allocated_status
from volcano_tpu_torch.scheduler.framework import Plugin
from volcano_tpu_torch.scheduler.session import EventHandler, Session


class _QueueAttr:
    __slots__ = ("uid", "name", "weight", "deserved", "allocated", "request", "share")

    def __init__(self, uid, name, weight):
        self.uid = uid
        self.name = name
        self.weight = weight
        self.deserved = Resource()
        self.allocated = Resource()
        self.request = Resource()
        self.share = 0.0

    def update_share(self):
        res = 0.0
        for rn in self.deserved.names():
            res = max(res, Resource.share(self.allocated.get(rn), self.deserved.get(rn)))
        self.share = res


class ProportionPlugin(Plugin):
    name = "proportion"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.total = Resource()
        self.queue_attrs = {}

    def on_session_open(self, ssn: Session) -> None:
        self.total = Resource()
        self.queue_attrs = {}
        for node in ssn.nodes.values():
            self.total.add(node.allocatable)

        # Only queues that have jobs participate (proportion.go:66-99).
        for job in ssn.jobs.values():
            if job.queue not in self.queue_attrs:
                queue = ssn.queues.get(job.queue)
                if queue is None:
                    continue
                self.queue_attrs[job.queue] = _QueueAttr(
                    queue.uid, queue.name, queue.weight
                )
            attr = self.queue_attrs[job.queue]
            for status, tasks in job.task_status_index.items():
                if allocated_status(status):
                    for t in tasks.values():
                        attr.allocated.add(t.resreq)
                        attr.request.add(t.resreq)
                elif status == TaskStatus.PENDING:
                    for t in tasks.values():
                        attr.request.add(t.resreq)

        # water-filling (proportion.go:101-144)
        remaining = self.total.clone()
        met = set()
        while True:
            total_weight = sum(
                a.weight for a in self.queue_attrs.values() if a.uid not in met
            )
            if total_weight == 0:
                break
            deserved_this_round = Resource()
            for attr in self.queue_attrs.values():
                if attr.uid in met:
                    continue
                old_deserved = attr.deserved.clone()
                attr.deserved.add(
                    remaining.clone().multi(attr.weight / total_weight)
                )
                if not attr.deserved.less_equal(attr.request):
                    attr.deserved = Resource.min(attr.deserved, attr.request)
                    met.add(attr.uid)
                attr.update_share()
                delta = attr.deserved.clone()
                # deserved grew monotonically, so subtraction is safe
                delta.milli_cpu -= old_deserved.milli_cpu
                delta.memory -= old_deserved.memory
                for k, v in old_deserved.scalars.items():
                    delta.scalars[k] = delta.scalars.get(k, 0.0) - v
                deserved_this_round.add(delta)
            remaining.milli_cpu -= deserved_this_round.milli_cpu
            remaining.memory -= deserved_this_round.memory
            for k, v in deserved_this_round.scalars.items():
                remaining.scalars[k] = remaining.scalars.get(k, 0.0) - v
            if remaining.is_empty():
                break

        def queue_order_fn(l, r):
            la = self.queue_attrs.get(l.uid)
            ra = self.queue_attrs.get(r.uid)
            ls = la.share if la else 0.0
            rs = ra.share if ra else 0.0
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_queue_order_fn(self.name, queue_order_fn)

        def reclaimable_fn(reclaimer, reclaimees):
            victims = []
            hypothetical = {}
            for reclaimee in reclaimees:
                job = ssn.jobs[reclaimee.job_uid]
                attr = self.queue_attrs.get(job.queue)
                if attr is None:
                    continue
                if job.queue not in hypothetical:
                    hypothetical[job.queue] = attr.allocated.clone()
                allocated = hypothetical[job.queue]
                if allocated.less(reclaimee.resreq):
                    continue
                allocated.sub(reclaimee.resreq)
                if attr.deserved.less_equal(allocated):
                    victims.append(reclaimee)
            return victims

        ssn.add_reclaimable_fn(self.name, reclaimable_fn)

        def overused_fn(queue):
            attr = self.queue_attrs.get(queue.uid)
            if attr is None:
                return False
            return attr.deserved.less_equal(attr.allocated)

        ssn.add_overused_fn(self.name, overused_fn)

        def on_allocate(event):
            job = ssn.jobs[event.task.job_uid]
            attr = self.queue_attrs.get(job.queue)
            if attr:
                attr.allocated.add(event.task.resreq)
                attr.update_share()

        def on_deallocate(event):
            job = ssn.jobs[event.task.job_uid]
            attr = self.queue_attrs.get(job.queue)
            if attr:
                attr.allocated.sub(event.task.resreq)
                attr.update_share()

        ssn.add_event_handler(
            EventHandler(allocate_func=on_allocate,
                         deallocate_func=on_deallocate, owner="proportion")
        )

    def resync(self, ssn: Session) -> None:
        """Recompute per-queue allocated/share from current session task
        state after a bulk device apply (deserved shares stay frozen for
        the cycle, as on the host path). Pipelined tasks count, matching
        the event path."""
        for attr in self.queue_attrs.values():
            attr.allocated = Resource()
        for job in ssn.jobs.values():
            attr = self.queue_attrs.get(job.queue)
            if attr is None:
                continue
            attr.allocated.add(job.allocated)
            for t in job.task_status_index.get(TaskStatus.PIPELINED, {}).values():
                attr.allocated.add(t.resreq)
        for attr in self.queue_attrs.values():
            attr.update_share()

    def on_session_close(self, ssn: Session) -> None:
        self.total = Resource()
        self.queue_attrs = {}

"""DRF plugin: Dominant Resource Fairness across jobs (the port's copy of
``volcano_tpu/scheduler/plugins/drf.py``).

share(job) = max over resource dims of allocated/clusterTotal; jobs with
lower share schedule first; a preemption victim is admissible if, after the
hypothetical transfer, the preemptor's share stays <= the victim's job share
(within shareDelta).
"""

from __future__ import annotations

from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import TaskStatus, allocated_status
from volcano_tpu_torch.scheduler.framework import Plugin
from volcano_tpu_torch.scheduler.session import EventHandler, Session

SHARE_DELTA = 0.000001


class DRFPlugin(Plugin):
    name = "drf"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.total = Resource()
        self.job_attrs = {}  # job uid -> {"allocated": Resource, "share": float}

    def on_session_open(self, ssn: Session) -> None:
        self.total = Resource()
        self.job_attrs = {}
        for node in ssn.nodes.values():
            self.total.add(node.allocatable)

        for job in ssn.jobs.values():
            allocated = Resource()
            for status, tasks in job.task_status_index.items():
                if allocated_status(status):
                    for t in tasks.values():
                        allocated.add(t.resreq)
            self.job_attrs[job.uid] = {
                "allocated": allocated,
                "share": allocated.dominant_share(self.total),
            }

        def preemptable_fn(preemptor, preemptees):
            latt = self.job_attrs[preemptor.job_uid]
            lalloc = latt["allocated"].clone().add(preemptor.resreq)
            ls = lalloc.dominant_share(self.total)

            victims = []
            hypothetical = {}
            for preemptee in preemptees:
                if preemptee.job_uid not in hypothetical:
                    hypothetical[preemptee.job_uid] = self.job_attrs[preemptee.job_uid][
                        "allocated"
                    ].clone()
                ralloc = hypothetical[preemptee.job_uid].sub(preemptee.resreq)
                rs = ralloc.dominant_share(self.total)
                if ls < rs or abs(ls - rs) <= SHARE_DELTA:
                    victims.append(preemptee)
            return victims

        ssn.add_preemptable_fn(self.name, preemptable_fn)

        def job_order_fn(l, r):
            ls = self.job_attrs[l.uid]["share"]
            rs = self.job_attrs[r.uid]["share"]
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_job_order_fn(self.name, job_order_fn)

        def on_allocate(event):
            attr = self.job_attrs[event.task.job_uid]
            attr["allocated"].add(event.task.resreq)
            attr["share"] = attr["allocated"].dominant_share(self.total)

        def on_deallocate(event):
            attr = self.job_attrs[event.task.job_uid]
            attr["allocated"].sub(event.task.resreq)
            attr["share"] = attr["allocated"].dominant_share(self.total)

        ssn.add_event_handler(
            EventHandler(allocate_func=on_allocate,
                         deallocate_func=on_deallocate, owner="drf")
        )

    def resync(self, ssn: Session) -> None:
        """Recompute shares from current session task state — called after a
        bulk device apply (which accounts shares on device and skips
        per-task events) so a host residue pass orders jobs correctly.
        Pipelined tasks count: the event path charges them via pipeline's
        allocate event."""
        for job in ssn.jobs.values():
            allocated = job.allocated.clone()
            for t in job.task_status_index.get(TaskStatus.PIPELINED, {}).values():
                allocated.add(t.resreq)
            self.job_attrs[job.uid] = {
                "allocated": allocated,
                "share": allocated.dominant_share(self.total),
            }

    def on_session_close(self, ssn: Session) -> None:
        self.total = Resource()
        self.job_attrs = {}

"""Priority plugin: order tasks and jobs by pod/PriorityClass priority (the
port's copy of ``volcano_tpu/scheduler/plugins/priority.py``)."""

from __future__ import annotations

from volcano_tpu_torch.scheduler.framework import Plugin
from volcano_tpu_torch.scheduler.session import Session


class PriorityPlugin(Plugin):
    name = "priority"

    def on_session_open(self, ssn: Session) -> None:
        def task_order_fn(l, r):
            if l.priority == r.priority:
                return 0
            return -1 if l.priority > r.priority else 1

        ssn.add_task_order_fn(self.name, task_order_fn)

        def job_order_fn(l, r):
            if l.priority == r.priority:
                return 0
            return -1 if l.priority > r.priority else 1

        ssn.add_job_order_fn(self.name, job_order_fn)

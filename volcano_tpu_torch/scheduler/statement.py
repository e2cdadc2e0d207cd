"""Transaction log for all-or-nothing gang preemption.

The port's copy of ``volcano_tpu/scheduler/statement.py``.  Evict/Pipeline mutate session state immediately and append to the op log;
Commit replays evictions against the cache (the real side effect); Discard
rolls back in reverse order (unevict to Running, unpipeline to Pending).
Each settlement is a ``statement.commit`` / ``statement.discard`` trace
span while the tracer is armed.
"""

from __future__ import annotations

from typing import List, Tuple

from volcano_tpu_torch import trace
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.scheduler.model import TaskInfo
from volcano_tpu_torch.scheduler.session import Event, Session


class Statement:
    def __init__(self, ssn: Session):
        self.ssn = ssn
        self.operations: List[Tuple[str, TaskInfo, str]] = []

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        ssn = self.ssn
        ssn.jobs[reclaimee.job_uid].update_task_status(reclaimee, TaskStatus.RELEASING)
        ssn.nodes[reclaimee.node_name].update_task(reclaimee)
        for eh in ssn.event_handlers:
            if eh.deallocate_func:
                eh.deallocate_func(Event(reclaimee))
        self.operations.append(("evict", reclaimee, reason))

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        ssn = self.ssn
        ssn.jobs[task.job_uid].update_task_status(task, TaskStatus.PIPELINED)
        task.node_name = hostname
        ssn.nodes[hostname].add_task(task)
        for eh in ssn.event_handlers:
            if eh.allocate_func:
                eh.allocate_func(Event(task))
        self.operations.append(("pipeline", task, hostname))

    def _unevict(self, reclaimee: TaskInfo) -> None:
        ssn = self.ssn
        ssn.jobs[reclaimee.job_uid].update_task_status(reclaimee, TaskStatus.RUNNING)
        ssn.nodes[reclaimee.node_name].update_task(reclaimee)
        for eh in ssn.event_handlers:
            if eh.allocate_func:
                eh.allocate_func(Event(reclaimee))

    def _unpipeline(self, task: TaskInfo) -> None:
        ssn = self.ssn
        ssn.jobs[task.job_uid].update_task_status(task, TaskStatus.PENDING)
        ssn.nodes[task.node_name].remove_task(task)
        task.node_name = ""
        for eh in ssn.event_handlers:
            if eh.deallocate_func:
                eh.deallocate_func(Event(task))

    def discard(self) -> None:
        with trace.span("statement.discard", ops=len(self.operations)):
            for name, task, _ in reversed(self.operations):
                if name == "evict":
                    self._unevict(task)
                else:
                    self._unpipeline(task)
        self.operations.clear()

    def commit(self) -> None:
        with trace.span("statement.commit", ops=len(self.operations)):
            for name, task, reason in self.operations:
                if name == "evict":
                    self.ssn.cache.evict(task, reason)
        self.operations.clear()

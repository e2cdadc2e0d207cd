"""Scheduler data model: TaskInfo / JobInfo / NodeInfo / QueueInfo / ClusterInfo.

The port's copy of ``volcano_tpu/scheduler/model.py``: the host-side
object view of a cluster snapshot that the object path's session, plugins
and actions operate on, and that the tensor snapshot is built from.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from volcano_tpu_torch.api.objects import Node, Pod, PodGroup, Queue
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import TaskStatus, allocated_status, task_status_of_pod


class TaskInfo:
    __slots__ = (
        "uid", "job_uid", "name", "namespace", "resreq", "init_resreq",
        "node_name", "status", "priority", "best_effort", "pod", "priority_class",
    )

    def __init__(self, pod: Pod, job_uid: str = ""):
        self.uid = pod.meta.uid
        self.job_uid = job_uid
        self.name = pod.meta.name
        self.namespace = pod.meta.namespace
        self.resreq = pod.spec.resreq()
        self.init_resreq = pod.spec.init_resreq()
        self.node_name = pod.node_name
        self.status = task_status_of_pod(pod)
        self.priority = pod.spec.priority
        self.priority_class = pod.spec.priority_class
        self.best_effort = self.resreq.is_empty()
        self.pod = pod

    def clone(self) -> "TaskInfo":
        t = TaskInfo.__new__(TaskInfo)
        for s in TaskInfo.__slots__:
            v = getattr(self, s)
            setattr(t, s, v.clone() if isinstance(v, Resource) else v)
        return t

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def __repr__(self):
        return (
            f"Task({self.key} job={self.job_uid} status={self.status.name} "
            f"node={self.node_name or '-'} req={self.resreq})"
        )


def render_fit_error(total_nodes: int, reasons: Dict[str, int]) -> str:
    """The "0/N nodes are available, <count> <reason>, ..." aggregate
    (job_info.go:338-373's format, reasons sorted for determinism)."""
    parts = sorted(f"{count} {reason}" for reason, count in reasons.items())
    return f"0/{total_nodes} nodes are available, {', '.join(parts)}."


class JobInfo:
    """A PodGroup + its member tasks, with per-status indexing."""

    def __init__(self, uid: str, pod_group: Optional[PodGroup] = None):
        self.uid = uid
        self.pod_group = pod_group
        self.name = pod_group.meta.name if pod_group else uid
        self.namespace = pod_group.meta.namespace if pod_group else "default"
        self.queue = pod_group.queue if pod_group else "default"
        self.min_available = pod_group.min_member if pod_group else 0
        self.priority = 0
        self.tasks: Dict[str, TaskInfo] = {}
        self.task_status_index: Dict[TaskStatus, Dict[str, TaskInfo]] = {}
        self.total_request = Resource()
        self.allocated = Resource()
        self.nodes_fit_delta: Dict[str, Resource] = {}
        # reason -> node count histogram for the head pending task that
        # could not be placed this cycle (job_info.go:338-373 analogue)
        self.fit_errors: Dict[str, int] = {}
        self.fit_total_nodes = 0
        # tensor path: lazy histogram producer () -> (total_nodes, reasons),
        # evaluated (and cached into fit_errors) on first fit_error() call so
        # the per-job numpy reductions only run for jobs someone reports on
        self.fit_error_fn: Optional[Callable[[], Tuple[int, Dict[str, int]]]] = None
        self.creation_order = 0

    # -- membership ---------------------------------------------------------

    def add_task(self, task: TaskInfo) -> None:
        task.job_uid = self.uid
        self.tasks[task.uid] = task
        self.task_status_index.setdefault(task.status, {})[task.uid] = task
        self.total_request.add(task.resreq)
        if allocated_status(task.status):
            self.allocated.add(task.resreq)

    def update_task_status(self, task: TaskInfo, status: TaskStatus) -> None:
        idx = self.task_status_index.get(task.status)
        if idx and task.uid in idx:
            del idx[task.uid]
            if not idx:
                del self.task_status_index[task.status]
        if allocated_status(task.status):
            self.allocated.sub(task.resreq)
        task.status = status
        # victims arrive as clones (preempt/reclaim); keep the canonical
        # task map pointing at the object whose status we just set
        self.tasks[task.uid] = task
        self.task_status_index.setdefault(status, {})[task.uid] = task
        if allocated_status(status):
            self.allocated.add(task.resreq)

    def tasks_with_status(self, *statuses: TaskStatus) -> List[TaskInfo]:
        out: List[TaskInfo] = []
        for s in statuses:
            out.extend(self.task_status_index.get(s, {}).values())
        return out

    # -- gang readiness (job_info.go:375-426) -------------------------------

    def ready_task_num(self) -> int:
        return sum(
            len(tasks)
            for status, tasks in self.task_status_index.items()
            if allocated_status(status) or status == TaskStatus.SUCCEEDED
        )

    def waiting_task_num(self) -> int:
        return len(self.task_status_index.get(TaskStatus.PIPELINED, {}))

    def valid_task_num(self) -> int:
        return sum(
            len(tasks)
            for status, tasks in self.task_status_index.items()
            if allocated_status(status)
            or status
            in (TaskStatus.SUCCEEDED, TaskStatus.PIPELINED, TaskStatus.PENDING)
        )

    def fit_error(self) -> str:
        """Aggregated unschedulable message: "0/N nodes are available,
        <count> <reason>, ...".  Sources, in precedence order: the reason
        histogram collected by allocate/backfill predicate sweeps
        (fit_errors), insufficient-dimension counts from nodes_fit_delta
        (job_info.go:338-373), or the tensor path's lazy producer.

        Returns "" when this cycle produced no fit data for the job (e.g.
        it was quota-blocked and allocate never examined it) — unlike the
        reference's misleading "0 nodes are available" fallback, callers
        append nothing rather than send operators chasing node capacity.
        """
        if (
            self.fit_error_fn is not None
            and not self.fit_errors
            and not self.nodes_fit_delta
        ):
            self.fit_total_nodes, produced = self.fit_error_fn()
            self.fit_errors = dict(produced)
            self.fit_error_fn = None  # evaluate once, even when empty
        reasons = dict(self.fit_errors)
        for delta in self.nodes_fit_delta.values():
            if delta.milli_cpu < 0:
                reasons["insufficient cpu"] = reasons.get("insufficient cpu", 0) + 1
            if delta.memory < 0:
                reasons["insufficient memory"] = (
                    reasons.get("insufficient memory", 0) + 1
                )
            for name, v in delta.scalars.items():
                if v < 0:
                    key = f"insufficient {name}"
                    reasons[key] = reasons.get(key, 0) + 1
        if not reasons:
            return ""
        total = max(self.fit_total_nodes, len(self.nodes_fit_delta))
        return render_fit_error(total, reasons)

    def ready(self) -> bool:
        return self.ready_task_num() >= self.min_available

    def pipelined(self) -> bool:
        return self.ready_task_num() + self.waiting_task_num() >= self.min_available

    def clone(self) -> "JobInfo":
        j = JobInfo(self.uid, self.pod_group)
        j.queue, j.min_available, j.priority = self.queue, self.min_available, self.priority
        j.name, j.namespace = self.name, self.namespace
        j.creation_order = self.creation_order
        for t in self.tasks.values():
            j.add_task(t.clone())
        return j

    def __repr__(self):
        return (
            f"Job({self.namespace}/{self.name} queue={self.queue} "
            f"min={self.min_available} tasks={len(self.tasks)})"
        )


def _sub_clamped(pool: Resource, req: Resource, deficit: Resource) -> None:
    """pool -= req, clamping each dim at zero; the shortfall accumulates in
    ``deficit`` so later refunds don't inflate the pool."""
    take = min(pool.milli_cpu, req.milli_cpu)
    deficit.milli_cpu += req.milli_cpu - take
    pool.milli_cpu -= take
    take = min(pool.memory, req.memory)
    deficit.memory += req.memory - take
    pool.memory -= take
    for k, v in req.scalars.items():
        have = pool.scalars.get(k, 0.0)
        take = min(have, v)
        deficit.scalars[k] = deficit.scalars.get(k, 0.0) + v - take
        pool.scalars[k] = have - take


def _add_refund(pool: Resource, req: Resource, deficit: Resource) -> None:
    """pool += req, but outstanding deficit absorbs the refund first."""
    pay = min(deficit.milli_cpu, req.milli_cpu)
    deficit.milli_cpu -= pay
    pool.milli_cpu += req.milli_cpu - pay
    pay = min(deficit.memory, req.memory)
    deficit.memory -= pay
    pool.memory += req.memory - pay
    for k, v in req.scalars.items():
        owed = deficit.scalars.get(k, 0.0)
        pay = min(owed, v)
        deficit.scalars[k] = owed - pay
        pool.scalars[k] = pool.scalars.get(k, 0.0) + v - pay


class NodeInfo:
    """Node + resource invariants: Idle/Used/Releasing vs Allocatable.

    Invariant (node_info.go): for every resident task,
      Releasing task: charged to Releasing, removed from Idle;
      Pipelined task: *refunds* Releasing (it will consume freed space);
      otherwise: removed from Idle.  Used accumulates all residents.

    Deviation from the reference: node_info.go's Idle.Sub panics when a
    node is oversubscribed (e.g. allocatable shrank below current usage).
    Here idle clamps at zero with deficit accounting — the node simply
    stops fitting new tasks, and capacity only returns once the deficit is
    paid back by departing residents.
    """

    def __init__(self, node: Node):
        self.node = node
        self.name = node.meta.name
        self.allocatable = node.allocatable.clone()
        self.idle = node.allocatable.clone()
        self.used = Resource()
        self.releasing = Resource()
        self.idle_deficit = Resource()
        self.releasing_deficit = Resource()
        self.tasks: Dict[str, TaskInfo] = {}

    def add_task(self, task: TaskInfo) -> None:
        if task.uid in self.tasks:
            raise ValueError(f"task {task.key} already on node {self.name}")
        t = task.clone()
        if t.status == TaskStatus.RELEASING:
            self.releasing.add(t.resreq)
            _sub_clamped(self.idle, t.resreq, self.idle_deficit)
        elif t.status == TaskStatus.PIPELINED:
            _sub_clamped(self.releasing, t.resreq, self.releasing_deficit)
        else:
            _sub_clamped(self.idle, t.resreq, self.idle_deficit)
        self.used.add(t.resreq)
        self.tasks[t.uid] = t

    def remove_task(self, task: TaskInfo) -> None:
        t = self.tasks.pop(task.uid, None)
        if t is None:
            raise ValueError(f"task {task.key} not on node {self.name}")
        if t.status == TaskStatus.RELEASING:
            _sub_clamped(self.releasing, t.resreq, self.releasing_deficit)
            _add_refund(self.idle, t.resreq, self.idle_deficit)
        elif t.status == TaskStatus.PIPELINED:
            _add_refund(self.releasing, t.resreq, self.releasing_deficit)
        else:
            _add_refund(self.idle, t.resreq, self.idle_deficit)
        self.used.sub(t.resreq)

    def update_task(self, task: TaskInfo) -> None:
        self.remove_task(task)
        self.add_task(task)

    def clone(self) -> "NodeInfo":
        n = NodeInfo(self.node)
        for t in self.tasks.values():
            n.add_task(t)
        return n

    def __repr__(self):
        return f"Node({self.name} idle={self.idle} used={self.used})"


class QueueInfo:
    def __init__(self, queue: Queue):
        self.uid = queue.meta.name
        self.name = queue.meta.name
        self.weight = queue.weight
        self.queue = queue

    def clone(self) -> "QueueInfo":
        return QueueInfo(self.queue)


@dataclass
class ClusterInfo:
    """One scheduling cycle's immutable view of the world."""

    jobs: Dict[str, JobInfo] = field(default_factory=dict)
    nodes: Dict[str, NodeInfo] = field(default_factory=dict)
    queues: Dict[str, QueueInfo] = field(default_factory=dict)

"""The per-cycle Session: snapshot + plugin callback registries + mutation ops.

The port's copy of ``volcano_tpu/scheduler/session.py``.  Tier semantics:
  * order fns: first non-zero comparison across tiers wins; fallback is
    creation order then UID;
  * preemptable/reclaimable: per-tier *intersection* across plugins; the
    first tier returning a non-None victim list decides;
  * predicates: AND across every enabled plugin in every tier;
  * node order: SUM of scores across every enabled plugin;
  * overused: any plugin says overused => overused;
  * job ready/pipelined: every enabled plugin must agree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from volcano_tpu_torch.api.objects import new_uid
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.scheduler.cache import VolumeBindingError
from volcano_tpu_torch.scheduler.conf import Tier
from volcano_tpu_torch.scheduler.model import ClusterInfo, JobInfo, NodeInfo, QueueInfo, TaskInfo


@dataclass
class Event:
    task: TaskInfo


@dataclass
class EventHandler:
    allocate_func: Optional[Callable[[Event], None]] = None
    deallocate_func: Optional[Callable[[Event], None]] = None
    # registering plugin; the bulk device-apply path only skips per-task
    # events for plugins whose accounting it models on device (and resyncs
    # after) — an unknown owner forces the exact replay path
    owner: str = ""


@dataclass
class ValidateResult:
    passed: bool
    reason: str = ""
    message: str = ""


class Session:
    def __init__(self, cache, tiers: List[Tier], cluster: ClusterInfo):
        self.uid = new_uid("session")
        self.cache = cache
        self.tiers = tiers
        self.jobs: Dict[str, JobInfo] = cluster.jobs
        self.nodes: Dict[str, NodeInfo] = cluster.nodes
        self.queues: Dict[str, QueueInfo] = cluster.queues

        # plugin callback registries: plugin name -> fn
        self.job_order_fns: Dict[str, Callable] = {}
        self.queue_order_fns: Dict[str, Callable] = {}
        self.task_order_fns: Dict[str, Callable] = {}
        self.predicate_fns: Dict[str, Callable] = {}
        self.node_order_fns: Dict[str, Callable] = {}
        self.preemptable_fns: Dict[str, Callable] = {}
        self.reclaimable_fns: Dict[str, Callable] = {}
        self.overused_fns: Dict[str, Callable] = {}
        self.job_ready_fns: Dict[str, Callable] = {}
        self.job_pipelined_fns: Dict[str, Callable] = {}
        self.job_valid_fns: Dict[str, Callable] = {}
        self.event_handlers: List[EventHandler] = []

        self.plugins: Dict[str, object] = {}
        # set by the scheduler (the tensor backend); actions consult it
        self.tensor_backend = None

    # -- registration (used by plugins in on_session_open) -------------------

    def add_job_order_fn(self, name, fn):
        self.job_order_fns[name] = fn

    def add_queue_order_fn(self, name, fn):
        self.queue_order_fns[name] = fn

    def add_task_order_fn(self, name, fn):
        self.task_order_fns[name] = fn

    def add_predicate_fn(self, name, fn):
        self.predicate_fns[name] = fn

    def add_node_order_fn(self, name, fn):
        self.node_order_fns[name] = fn

    def add_preemptable_fn(self, name, fn):
        self.preemptable_fns[name] = fn

    def add_reclaimable_fn(self, name, fn):
        self.reclaimable_fns[name] = fn

    def add_overused_fn(self, name, fn):
        self.overused_fns[name] = fn

    def add_job_ready_fn(self, name, fn):
        self.job_ready_fns[name] = fn

    def add_job_pipelined_fn(self, name, fn):
        self.job_pipelined_fns[name] = fn

    def add_job_valid_fn(self, name, fn):
        self.job_valid_fns[name] = fn

    def add_event_handler(self, handler: EventHandler):
        self.event_handlers.append(handler)

    # -- tier dispatch -------------------------------------------------------

    def _ordered(self, registry, flag: str):
        for tier in self.tiers:
            for plugin in tier.plugins:
                if flag and not getattr(plugin, flag, True):
                    continue
                fn = registry.get(plugin.name)
                if fn is not None:
                    yield tier, plugin, fn

    def job_order_fn(self, l: JobInfo, r: JobInfo) -> bool:
        for _, _, fn in self._ordered(self.job_order_fns, "enabled_job_order"):
            j = fn(l, r)
            if j != 0:
                return j < 0
        if l.creation_order != r.creation_order:
            return l.creation_order < r.creation_order
        return l.uid < r.uid

    def queue_order_fn(self, l: QueueInfo, r: QueueInfo) -> bool:
        for _, _, fn in self._ordered(self.queue_order_fns, "enabled_queue_order"):
            j = fn(l, r)
            if j != 0:
                return j < 0
        return l.uid < r.uid

    def task_compare(self, l: TaskInfo, r: TaskInfo) -> int:
        for _, _, fn in self._ordered(self.task_order_fns, "enabled_task_order"):
            j = fn(l, r)
            if j != 0:
                return j
        return 0

    def task_order_fn(self, l: TaskInfo, r: TaskInfo) -> bool:
        j = self.task_compare(l, r)
        if j != 0:
            return j < 0
        return l.uid < r.uid

    def predicate_fn(self, task: TaskInfo, node: NodeInfo) -> Optional[str]:
        """Returns None if every enabled predicate admits (task, node),
        else the first failure reason."""
        for _, _, fn in self._ordered(self.predicate_fns, "enabled_predicate"):
            err = fn(task, node)
            if err is not None:
                return err
        return None

    def node_order_fn(self, task: TaskInfo, node: NodeInfo) -> float:
        score = 0.0
        for _, _, fn in self._ordered(self.node_order_fns, "enabled_node_order"):
            score += fn(task, node)
        return score

    def _victims_tiered(self, registry, flag, actor, candidates):
        for tier in self.tiers:
            victims: Optional[List[TaskInfo]] = None
            init = False
            for plugin in tier.plugins:
                if not getattr(plugin, flag, True):
                    continue
                fn = registry.get(plugin.name)
                if fn is None:
                    continue
                cand = fn(actor, candidates)
                if not init:
                    victims, init = cand, True
                else:
                    cand_ids = {c.uid for c in (cand or [])}
                    victims = [v for v in (victims or []) if v.uid in cand_ids]
            if victims is not None:
                return victims
        return None

    def preemptable(self, preemptor, preemptees) -> Optional[List[TaskInfo]]:
        return self._victims_tiered(
            self.preemptable_fns, "enabled_preemptable", preemptor, preemptees
        )

    def reclaimable(self, reclaimer, reclaimees) -> Optional[List[TaskInfo]]:
        return self._victims_tiered(
            self.reclaimable_fns, "enabled_reclaimable", reclaimer, reclaimees
        )

    def overused(self, queue: QueueInfo) -> bool:
        # note: the reference checks overusedFns of ALL plugins regardless of
        # enable flags (session_plugins.go Overused) — reproduced here.
        for tier in self.tiers:
            for plugin in tier.plugins:
                fn = self.overused_fns.get(plugin.name)
                if fn is not None and fn(queue):
                    return True
        return False

    def job_ready(self, job: JobInfo) -> bool:
        for _, _, fn in self._ordered(self.job_ready_fns, "enabled_job_ready"):
            if not fn(job):
                return False
        return True

    def job_pipelined(self, job: JobInfo) -> bool:
        for _, _, fn in self._ordered(self.job_pipelined_fns, "enabled_job_pipelined"):
            if not fn(job):
                return False
        return True

    def job_valid(self, job: JobInfo) -> Optional[ValidateResult]:
        for tier in self.tiers:
            for plugin in tier.plugins:
                fn = self.job_valid_fns.get(plugin.name)
                if fn is None:
                    continue
                vr = fn(job)
                if vr is not None and not vr.passed:
                    return vr
        return None

    def resync_plugin_shares(self) -> None:
        """Rebuild plugin fair-share state from current session task state.
        Called after a bulk device apply (shares were accounted on device,
        per-task events skipped) before any host pass that reads them."""
        for plugin in self.plugins.values():
            resync = getattr(plugin, "resync", None)
            if resync is not None:
                resync(self)

    # -- mutation ops (session.go:194-331) -----------------------------------

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        job = self.jobs[task.job_uid]
        job.update_task_status(task, TaskStatus.PIPELINED)
        task.node_name = hostname
        self.nodes[hostname].add_task(task)
        for eh in self.event_handlers:
            if eh.allocate_func:
                eh.allocate_func(Event(task))

    def allocate(self, task: TaskInfo, hostname: str) -> None:
        self.cache.allocate_volumes(task.pod, hostname)
        job = self.jobs[task.job_uid]
        job.update_task_status(task, TaskStatus.ALLOCATED)
        task.node_name = hostname
        self.nodes[hostname].add_task(task)
        for eh in self.event_handlers:
            if eh.allocate_func:
                eh.allocate_func(Event(task))
        if self.job_ready(job):
            for t in list(job.task_status_index.get(TaskStatus.ALLOCATED, {}).values()):
                self.dispatch(t)

    def dispatch(self, task: TaskInfo) -> None:
        try:
            self.cache.bind_volumes(task.pod)
        except VolumeBindingError as e:
            # the assumed PV vanished between allocate and bind: skip the
            # bind (store untouched, task retried by next cycle's snapshot)
            # instead of unwinding the gang dispatch loop mid-flight —
            # failed-side-effect semantics, same as a failed cache.bind
            self.cache._record_err("bind_volumes", task.key, e)
            return
        self.cache.bind(task, task.node_name)
        job = self.jobs[task.job_uid]
        job.update_task_status(task, TaskStatus.BINDING)

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        self.cache.evict(reclaimee, reason)
        job = self.jobs[reclaimee.job_uid]
        job.update_task_status(reclaimee, TaskStatus.RELEASING)
        self.nodes[reclaimee.node_name].update_task(reclaimee)
        for eh in self.event_handlers:
            if eh.deallocate_func:
                eh.deallocate_func(Event(reclaimee))

    # session-only eviction primitives used by Statement rollback
    def evict_in_session(self, reclaimee: TaskInfo) -> None:
        job = self.jobs[reclaimee.job_uid]
        job.update_task_status(reclaimee, TaskStatus.RELEASING)
        self.nodes[reclaimee.node_name].update_task(reclaimee)
        for eh in self.event_handlers:
            if eh.deallocate_func:
                eh.deallocate_func(Event(reclaimee))

    def unevict_in_session(self, reclaimee: TaskInfo, status: TaskStatus) -> None:
        job = self.jobs[reclaimee.job_uid]
        job.update_task_status(reclaimee, status)
        self.nodes[reclaimee.node_name].update_task(reclaimee)
        for eh in self.event_handlers:
            if eh.allocate_func:
                eh.allocate_func(Event(reclaimee))

    def unpipeline(self, task: TaskInfo) -> None:
        job = self.jobs[task.job_uid]
        job.update_task_status(task, TaskStatus.PENDING)
        self.nodes[task.node_name].remove_task(task)
        task.node_name = ""
        for eh in self.event_handlers:
            if eh.deallocate_func:
                eh.deallocate_func(Event(task))

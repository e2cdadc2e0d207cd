"""Plugin/action registries + session lifecycle.

The port's copy of ``volcano_tpu/scheduler/framework.py``: the action and
plugin registries, ``open_session`` (snapshot, the JobValid gate, plugin
OnSessionOpen) and ``close_session`` (plugin OnSessionClose, then each
PodGroup's phase and counts written back through the cache), each plugin
callback's wall recorded in ``metrics``, and the trace spans
``session.snapshot``, ``plugin`` (each callback) and ``session.close``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from volcano_tpu_torch import trace
from volcano_tpu_torch.api.objects import PodGroupCondition
from volcano_tpu_torch.api.types import PodGroupPhase, TaskStatus, allocated_status
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.scheduler.conf import Tier
from volcano_tpu_torch.scheduler.session import Session

_action_registry: Dict[str, object] = {}
_plugin_builders: Dict[str, Callable[[Dict[str, str]], object]] = {}


class Action:
    """One scheduling pass per cycle (enqueue/allocate/backfill/preempt/reclaim)."""

    name = "action"

    def execute(self, ssn: Session) -> None:
        raise NotImplementedError


class Plugin:
    """A policy: registers callbacks into the Session at open time."""

    name = "plugin"

    def __init__(self, arguments: Optional[Dict[str, str]] = None):
        self.arguments = arguments or {}

    def on_session_open(self, ssn: Session) -> None:
        raise NotImplementedError

    def on_session_close(self, ssn: Session) -> None:
        pass


def register_action(action: Action) -> None:
    _action_registry[action.name] = action


def get_action(name: str) -> Optional[Action]:
    return _action_registry.get(name)


def register_plugin_builder(name: str, builder) -> None:
    _plugin_builders[name] = builder


def get_plugin_builder(name: str):
    return _plugin_builders.get(name)


def open_session(cache, tiers: List[Tier]) -> Session:
    """Snapshot the cluster, gate invalid jobs, run plugin OnSessionOpen.

    The JobValid gate runs before any plugin registers callbacks, so at
    gate time the registry is empty and no job is dropped: pod-less
    PodGroups must survive into the session for enqueue to admit them."""
    # start from clean volume session state even if the previous cycle
    # aborted before close_session could clear it
    cache.clear_session_volumes()
    with trace.span("session.snapshot"):
        cluster = cache.snapshot()
    ssn = Session(cache, tiers, cluster)

    for uid, job in list(ssn.jobs.items()):
        vr = ssn.job_valid(job)
        if vr is not None and not vr.passed:
            if job.pod_group is not None:
                cond = PodGroupCondition(kind="Unschedulable", status="True",
                                         reason=vr.reason, message=vr.message)
                job.pod_group.status.conditions = [
                    c for c in job.pod_group.status.conditions if c.kind != "Unschedulable"
                ] + [cond]
                cache.update_job_status(job)
            del ssn.jobs[uid]

    for tier in tiers:
        for opt in tier.plugins:
            builder = get_plugin_builder(opt.name)
            if builder is None:
                continue
            if opt.name not in ssn.plugins:
                ssn.plugins[opt.name] = builder(opt.arguments)

    for plugin in ssn.plugins.values():
        start = time.perf_counter()
        with trace.span("plugin", plugin=plugin.name, callback="OnSessionOpen"):
            plugin.on_session_open(ssn)
        metrics.update_plugin_duration(plugin.name, "OnSessionOpen", start)
    return ssn


def close_session(ssn: Session) -> None:
    # drop session-scoped assumed volume assignments (gangs that never
    # became ready release their volumes)
    ssn.cache.clear_session_volumes()
    for plugin in ssn.plugins.values():
        start = time.perf_counter()
        with trace.span("plugin", plugin=plugin.name, callback="OnSessionClose"):
            plugin.on_session_close(ssn)
        metrics.update_plugin_duration(plugin.name, "OnSessionClose", start)
    with trace.span("session.close"):
        for job in ssn.jobs.values():
            if job.pod_group is None:
                continue
            _update_pod_group_status(ssn, job)
            ssn.cache.update_job_status(job)


def _update_pod_group_status(ssn: Session, job) -> None:
    """The PodGroup phase and counts, with the strict ``allocated >
    min_member`` comparison for the Running phase."""
    pg = job.pod_group
    unschedulable = any(
        c.kind == "Unschedulable" and c.status == "True" for c in pg.status.conditions
    )
    running = len(job.task_status_index.get(TaskStatus.RUNNING, {}))
    if running and unschedulable:
        pg.status.phase = PodGroupPhase.UNKNOWN
    else:
        allocated = sum(
            len(tasks)
            for status, tasks in job.task_status_index.items()
            if allocated_status(status)
        )
        if allocated > pg.min_member:
            pg.status.phase = PodGroupPhase.RUNNING
        elif pg.status.phase != PodGroupPhase.INQUEUE:
            pg.status.phase = PodGroupPhase.PENDING
    pg.status.running = running
    pg.status.failed = len(job.task_status_index.get(TaskStatus.FAILED, {}))
    pg.status.succeeded = len(job.task_status_index.get(TaskStatus.SUCCEEDED, {}))

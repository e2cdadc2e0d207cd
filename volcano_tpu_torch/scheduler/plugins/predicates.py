"""Predicates plugin: node filtering checks (the port's copy of
``volcano_tpu/scheduler/plugins/predicates.py``).  Checks, in order: max
task num, node condition, node unschedulable, node selector + required
node affinity, host ports, taints/tolerations, memory/disk/pid pressure,
pod (anti)affinity against pods resident on the node, volume binding.
"""

from __future__ import annotations

from typing import Optional

from volcano_tpu_torch.api.objects import match_expressions
from volcano_tpu_torch.scheduler.framework import Plugin
from volcano_tpu_torch.scheduler.model import NodeInfo, TaskInfo
from volcano_tpu_torch.scheduler.session import Session


def node_selector_fits(task: TaskInfo, node: NodeInfo) -> bool:
    """PodMatchNodeSelector: node_selector labels AND required node affinity."""
    spec = task.pod.spec
    labels = node.node.labels
    for k, v in spec.node_selector.items():
        if labels.get(k) != v:
            return False
    aff = spec.affinity
    if aff and aff.node_terms:
        # OR across terms, AND within a term
        if not any(match_expressions(labels, term) for term in aff.node_terms):
            return False
    return True


def taints_tolerated(task: TaskInfo, node: NodeInfo) -> bool:
    """PodToleratesNodeTaints: NoSchedule/NoExecute taints must be tolerated."""
    tolerations = task.pod.spec.tolerations
    for taint in node.node.taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return False
    return True


def host_ports_free(task: TaskInfo, node: NodeInfo) -> bool:
    wanted = set(task.pod.spec.host_ports)
    if not wanted:
        return True
    for resident in node.tasks.values():
        if wanted.intersection(resident.pod.spec.host_ports):
            return False
    return True


def _match_selector(labels, selector) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


def pod_affinity_fits(task: TaskInfo, node: NodeInfo) -> bool:
    """Required pod (anti)affinity with node-level topology."""
    aff = task.pod.spec.affinity
    if aff is None:
        return True
    resident = [t.pod for t in node.tasks.values()]
    for selector in aff.pod_affinity:
        if not any(_match_selector(p.meta.labels, selector) for p in resident):
            return False
    for selector in aff.pod_anti_affinity:
        if any(_match_selector(p.meta.labels, selector) for p in resident):
            return False
        # self-anti-affinity: a pod that anti-matches itself conflicts with
        # like-labeled pods already placed (standard k8s semantics)
    return True


PRESSURE_CONDITIONS = ("MemoryPressure", "DiskPressure", "PIDPressure")


class PredicatesPlugin(Plugin):
    name = "predicates"

    def on_session_open(self, ssn: Session) -> None:
        def predicate_fn(task: TaskInfo, node: NodeInfo) -> Optional[str]:
            # reasons are canonical (node-free) so JobInfo.fit_error() can
            # histogram them across nodes; the caller knows which node failed
            n = node.node
            max_tasks = node.allocatable.max_task_num
            if max_tasks is not None and len(node.tasks) + 1 > max_tasks:
                return "node(s) had too many tasks"
            if not n.ready():
                return "node(s) were not ready"
            if n.unschedulable:
                return "node(s) were unschedulable"
            if not node_selector_fits(task, node):
                return "node(s) didn't match node selector"
            if not host_ports_free(task, node):
                return "node(s) didn't have free ports"
            if not taints_tolerated(task, node):
                return "node(s) had taints that the pod didn't tolerate"
            for cond in n.conditions:
                if cond.kind in PRESSURE_CONDITIONS and cond.status == "True":
                    return f"node(s) had {cond.kind}"
            if not pod_affinity_fits(task, node):
                return "node(s) didn't satisfy pod affinity/anti-affinity"
            # volume binding predicate: bound-PV node affinity / static-PV
            # availability
            return ssn.cache.volume_fit(task.pod, n.labels)

        ssn.add_predicate_fn(self.name, predicate_fn)

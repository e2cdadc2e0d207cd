"""NodeOrder plugin: weighted-sum node scoring (the port's copy of
``volcano_tpu/scheduler/plugins/nodeorder.py``).

Score formulas (upstream k8s priorities, 0-10 scale per component):
  least_requested  = ((cap-req)*10/cap for cpu + same for mem) / 2
  balanced         = 10 - |cpuFraction - memFraction| * 10
  node_affinity    = sum of weights of matching preferred node terms
  interpod         = sum of matching preferred pod-affinity weights on node
Weights come from plugin arguments (leastrequested.weight etc., default 1).
"""

from __future__ import annotations

from volcano_tpu_torch.api.objects import match_expressions
from volcano_tpu_torch.scheduler.conf import get_plugin_arg
from volcano_tpu_torch.scheduler.framework import Plugin
from volcano_tpu_torch.scheduler.model import NodeInfo, TaskInfo
from volcano_tpu_torch.scheduler.session import Session


def least_requested_score(task: TaskInfo, node: NodeInfo) -> float:
    """(capacity - requested) * 10 / capacity, averaged over cpu+mem.

    "requested" counts resources already used plus this task's request.
    """
    score = 0.0
    for dim in ("cpu", "memory"):
        cap = node.allocatable.get(dim)
        req = node.used.get(dim) + task.resreq.get(dim)
        if cap > 0:
            score += max(0.0, (cap - req)) * 10.0 / cap
    return score / 2.0


def balanced_resource_score(task: TaskInfo, node: NodeInfo) -> float:
    cap_cpu = node.allocatable.get("cpu")
    cap_mem = node.allocatable.get("memory")
    if cap_cpu <= 0 or cap_mem <= 0:
        return 0.0
    cpu_frac = (node.used.get("cpu") + task.resreq.get("cpu")) / cap_cpu
    mem_frac = (node.used.get("memory") + task.resreq.get("memory")) / cap_mem
    if cpu_frac >= 1.0 or mem_frac >= 1.0:
        return 0.0
    return 10.0 - abs(cpu_frac - mem_frac) * 10.0


def node_affinity_score(task: TaskInfo, node: NodeInfo) -> float:
    aff = task.pod.spec.affinity
    if aff is None:
        return 0.0
    score = 0.0
    for weight, term in aff.preferred_node_terms:
        if match_expressions(node.node.labels, term):
            score += weight
    return score


def interpod_affinity_score(task: TaskInfo, node: NodeInfo) -> float:
    aff = task.pod.spec.affinity
    if aff is None:
        return 0.0
    score = 0.0
    for t in node.tasks.values():
        labels = t.pod.meta.labels
        for selector in aff.pod_affinity:
            if all(labels.get(k) == v for k, v in selector.items()):
                score += 1.0
        for selector in aff.pod_anti_affinity:
            if all(labels.get(k) == v for k, v in selector.items()):
                score -= 1.0
    return score


class NodeOrderPlugin(Plugin):
    name = "nodeorder"

    def on_session_open(self, ssn: Session) -> None:
        args = self.arguments
        w_least = get_plugin_arg(args, "leastrequested.weight", 1.0)
        w_balanced = get_plugin_arg(args, "balancedresource.weight", 1.0)
        w_nodeaff = get_plugin_arg(args, "nodeaffinity.weight", 1.0)
        w_podaff = get_plugin_arg(args, "podaffinity.weight", 1.0)

        def node_order_fn(task: TaskInfo, node: NodeInfo) -> float:
            return (
                w_least * least_requested_score(task, node)
                + w_balanced * balanced_resource_score(task, node)
                + w_nodeaff * node_affinity_score(task, node)
                + w_podaff * interpod_affinity_score(task, node)
            )

        ssn.add_node_order_fn(self.name, node_order_fn)

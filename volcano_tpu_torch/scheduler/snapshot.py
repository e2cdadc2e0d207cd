"""Tensorized cluster snapshot: the dense per-cycle view the solves read.

Counterpart of ``volcano_tpu/scheduler/snapshot.py``, cut to what the
fast cycle uses: the ``TensorSnapshot`` arrays (the victim pool's ``run_*``
fields included) (numpy, host side;
``tensor_backend`` moves them to the device), shape bucketing, and the
static predicate-class helpers (node selector, required node affinity,
taints/tolerations, node conditions, preferred node-affinity score).
Tasks sharing a (selector, affinity, tolerations, ports) template share one
[N] predicate row, so no [T, N] mask is ever built.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from volcano_tpu_torch.api.objects import Node, Pod, match_expressions


def _bucket(n: int, minimum: int = 8) -> int:
    """Round up to the next power of two (>= minimum) for shape reuse."""
    size = minimum
    while size < n:
        size *= 2
    return size


@dataclass
class TensorSnapshot:
    """Dense arrays describing one scheduling cycle, padded to bucket sizes
    N/T/J/Q/C with validity masks; R = 2 + interned scalar resources."""

    dims: List[str]
    eps: np.ndarray                    # [R]

    node_names: List[str]
    node_idle: np.ndarray              # [N, R]
    node_releasing: np.ndarray         # [N, R]
    node_used: np.ndarray              # [N, R]
    node_alloc: np.ndarray             # [N, R] allocatable
    node_max_tasks: np.ndarray         # [N] i32 (INT32_MAX if unset)
    node_task_count: np.ndarray        # [N] i32
    node_valid: np.ndarray             # [N] bool

    task_uids: List[str]               # index -> pod key
    task_req: np.ndarray               # [T, R] init_resreq
    task_job: np.ndarray               # [T] i32
    task_class: np.ndarray             # [T] i32 predicate class
    task_valid: np.ndarray             # [T] bool

    job_uids: List[str]
    job_queue: np.ndarray              # [J] i32
    job_min_available: np.ndarray      # [J] i32
    job_priority: np.ndarray           # [J] i32
    job_creation: np.ndarray           # [J] i32
    job_ready_init: np.ndarray         # [J] i32
    job_alloc_init: np.ndarray         # [J, R]
    job_schedulable: np.ndarray        # [J] bool (podgroup phase != Pending)
    job_start: np.ndarray              # [J] i32 offset into task arrays
    job_ntasks: np.ndarray             # [J] i32 pending task count

    queue_names: List[str]
    queue_weight: np.ndarray           # [Q] f32
    queue_alloc_init: np.ndarray       # [Q, R]
    queue_request: np.ndarray          # [Q, R] alloc + pending
    queue_valid: np.ndarray            # [Q] bool
    queue_participates: np.ndarray     # [Q] bool

    class_node_mask: np.ndarray        # [C, N] bool
    class_node_score: np.ndarray       # [C, N] f32 static score (node affinity)

    total: np.ndarray = field(default=None)  # [R] cluster allocatable total

    # running tasks: the victim pool of preempt and reclaim, grouped by node
    # (snapshot order), within a node by arrival; filled by
    # fastpath.snapshot_build.build_victim_pool on contended cycles only
    run_uids: List[str] = field(default_factory=list)
    run_req: np.ndarray = field(default=None)        # [V, R] resreq
    run_node: np.ndarray = field(default=None)       # [V] i32
    run_job: np.ndarray = field(default=None)        # [V] i32
    run_prio: np.ndarray = field(default=None)       # [V] i32
    run_rank: np.ndarray = field(default=None)       # [V] i32 arrival rank
    run_evictable: np.ndarray = field(default=None)  # [V] bool (conformance)
    run_valid: np.ndarray = field(default=None)      # [V] bool


def _task_class_key(pod: Pod):
    spec = pod.spec
    aff = spec.affinity
    return (
        tuple(sorted(spec.node_selector.items())),
        tuple(tuple(term) for term in (aff.node_terms if aff else ())),
        tuple((w, tuple(term)) for w, term in (aff.preferred_node_terms if aff else ())),
        tuple((t.key, t.operator, t.value, t.effect) for t in spec.tolerations),
        tuple(spec.host_ports),
    )


def node_selector_fits(pod: Pod, node: Node) -> bool:
    """PodMatchNodeSelector: node_selector labels AND required node affinity."""
    spec = pod.spec
    labels = node.labels
    for k, v in spec.node_selector.items():
        if labels.get(k) != v:
            return False
    aff = spec.affinity
    if aff and aff.node_terms:
        if not any(match_expressions(labels, term) for term in aff.node_terms):
            return False
    return True


def taints_tolerated(pod: Pod, node: Node) -> bool:
    """PodToleratesNodeTaints: NoSchedule/NoExecute taints must be tolerated."""
    tolerations = pod.spec.tolerations
    for taint in node.taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return False
    return True


def _static_predicate(pod: Pod, node: Node) -> bool:
    """The node-template-dependent part of the predicate chain: everything
    except resource fit, max-task-count and resident-pod-dependent checks."""
    if not node.ready() or node.unschedulable:
        return False
    for cond in node.conditions:
        if cond.kind in ("MemoryPressure", "DiskPressure", "PIDPressure") and cond.status == "True":
            return False
    return node_selector_fits(pod, node) and taints_tolerated(pod, node)


def node_affinity_score(pod: Pod, node: Node) -> float:
    """Preferred node-affinity terms' summed weights (nodeorder plugin)."""
    aff = pod.spec.affinity
    if aff is None:
        return 0.0
    score = 0.0
    for weight, term in aff.preferred_node_terms:
        if match_expressions(node.labels, term):
            score += weight
    return score

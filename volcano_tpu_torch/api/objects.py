"""Cluster objects the express cycle reads and writes: Pod, Node, PodGroup,
Queue, PriorityClass (the port's copy of ``volcano_tpu/api/objects.py``,
without volume objects, budgets, node pools and commands)."""

from __future__ import annotations

import itertools
import os
import secrets
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import PodGroupPhase, PodPhase

#: PodGroup annotation linking a pod to its gang
POD_GROUP_KEY = "scheduling.volcano.tpu/group-name"

_uid_lock = threading.Lock()
_uid_counter = itertools.count(1)
_uid_token = f"{os.getpid():x}{secrets.token_hex(2)}"


def new_uid(prefix: str = "obj") -> str:
    with _uid_lock:
        n = next(_uid_counter)
    return f"{prefix}-{_uid_token}-{n:08d}"


@dataclass
class Metadata:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    resource_version: int = 0
    creation_timestamp: float = 0.0
    owner: Optional[Tuple[str, str]] = None  # (kind, name) of controlling object

    def __post_init__(self):
        if not self.uid:
            self.uid = new_uid(self.name or "obj")

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists; empty key + Exists tolerates all
    value: str = ""
    effect: str = ""  # empty matches all effects

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if not self.key:
            return self.operator == "Exists"
        if self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


@dataclass
class Affinity:
    """node_terms: OR-of-AND (key, op, values) label requirements;
    preferred_node_terms: (weight, term) pairs for scoring; pod
    (anti)affinity: label selectors over pods resident on the node."""

    node_terms: List[List[Tuple[str, str, Tuple[str, ...]]]] = field(default_factory=list)
    preferred_node_terms: List[Tuple[int, List[Tuple[str, str, Tuple[str, ...]]]]] = field(
        default_factory=list
    )
    pod_affinity: List[Dict[str, str]] = field(default_factory=list)
    pod_anti_affinity: List[Dict[str, str]] = field(default_factory=list)


def match_expressions(labels: Dict[str, str], term) -> bool:
    """Evaluate one AND-term of (key, op, values) against a label map."""
    for key, op, values in term:
        v = labels.get(key)
        if op == "In":
            if v is None or v not in values:
                return False
        elif op == "NotIn":
            if v is not None and v in values:
                return False
        elif op == "Exists":
            if v is None:
                return False
        elif op == "DoesNotExist":
            if v is not None:
                return False
        elif op == "Gt":
            if v is None or not v.lstrip("-").isdigit() or int(v) <= int(values[0]):
                return False
        elif op == "Lt":
            if v is None or not v.lstrip("-").isdigit() or int(v) >= int(values[0]):
                return False
        else:
            return False
    return True


@dataclass
class PodSpec:
    resources: Resource = field(default_factory=Resource)       # sum of containers
    init_resources: Resource = field(default_factory=Resource)  # max of init containers
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    host_ports: List[int] = field(default_factory=list)
    priority_class: str = ""
    priority: int = 0
    scheduler_name: str = "volcano-tpu"

    def resreq(self) -> Resource:
        return self.resources.clone()

    def init_resreq(self) -> Resource:
        r = self.resources.clone()
        r.set_max(self.init_resources)
        return r


@dataclass
class Pod:
    meta: Metadata
    spec: PodSpec = field(default_factory=PodSpec)
    phase: PodPhase = PodPhase.PENDING
    node_name: str = ""
    deleting: bool = False
    volumes: List[str] = field(default_factory=list)  # mounted claim names

    @property
    def key(self) -> str:
        return self.meta.key


@dataclass
class NodeCondition:
    kind: str  # Ready | MemoryPressure | DiskPressure | PIDPressure
    status: str = "True"


@dataclass
class Node:
    meta: Metadata
    allocatable: Resource = field(default_factory=Resource)
    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False
    conditions: List[NodeCondition] = field(default_factory=lambda: [NodeCondition("Ready")])

    def __post_init__(self):
        # node name is both metadata and a label (kubernetes.io/hostname)
        self.labels.setdefault("kubernetes.io/hostname", self.meta.name)

    def ready(self) -> bool:
        for c in self.conditions:
            if c.kind == "Ready":
                return c.status == "True"
        return False


@dataclass
class PodGroupCondition:
    kind: str
    status: str
    reason: str = ""
    message: str = ""


@dataclass
class PodGroupStatus:
    phase: PodGroupPhase = PodGroupPhase.PENDING
    conditions: List[PodGroupCondition] = field(default_factory=list)
    running: int = 0
    succeeded: int = 0
    failed: int = 0


@dataclass
class PodGroup:
    meta: Metadata
    min_member: int = 1
    queue: str = "default"
    priority_class_name: str = ""
    min_resources: Resource = field(default_factory=Resource)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)


@dataclass
class Queue:
    meta: Metadata
    weight: int = 1


@dataclass
class PriorityClass:
    meta: Metadata
    value: int = 0
    global_default: bool = False

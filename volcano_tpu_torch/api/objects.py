"""Cluster objects the fast cycle reads and writes: Pod, Node, PodGroup,
Queue, PriorityClass and the volume objects PersistentVolumeClaim,
StorageClass and PersistentVolume (the port's copy of
``volcano_tpu/api/objects.py``, without budgets, node pools and
commands)."""

from __future__ import annotations

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
_uid_next = 1
# process-unique token: uids (and the Event names built from them) must not
# collide across processes that each run their own counter
_uid_token = f"{os.getpid():x}{secrets.token_hex(2)}"


def _advance_uids(n: int) -> int:
    global _uid_next
    with _uid_lock:
        start = _uid_next
        _uid_next += n
    return start


def new_uid(prefix: str = "obj") -> str:
    return f"{prefix}-{_uid_token}-{_advance_uids(1):08d}"


def reserve_uids(prefix: str, n: int) -> Tuple[str, int]:
    """Reserve ``n`` consecutive uid-counter slots in one lock hold and
    return ``(token, start)``: slot ``start + i`` names the uid
    ``f"{prefix}-{token}-{start + i:08d}"``.  A decision segment reserves
    its whole Event block this way (``store/segment.py``)."""
    del prefix  # part of the derived name, not of the reservation
    return _uid_token, _advance_uids(n)


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


@dataclass
class PodDisruptionBudget:
    """Gang grouping for plain controller-owned pods (reference: the PDB
    informer and SetPDB): pods sharing the budget's controlling owner form
    one shadow job whose MinAvailable comes from the budget."""

    meta: Metadata  # meta.owner = the controlling object, shared with pods
    min_available: int = 1


@dataclass
class PersistentVolumeClaim:
    """A volume claim mounted by pods (``Pod.volumes`` names it).

    WaitForFirstConsumer semantics: the claim stays ``Pending`` until a pod
    that mounts it is scheduled; the scheduler's VolumeBinder picks (or
    provisions) a PV at allocate time and commits it at bind time."""

    meta: Metadata
    size: str = ""
    storage_class: str = ""
    volume_name: str = ""      # bound PV name; empty while Pending
    phase: str = "Pending"     # Pending | Bound


@dataclass
class StorageClass:
    """Provisioning policy for claims: an empty ``provisioner`` means
    static-only (claims bind to pre-created PVs); otherwise a PV is
    provisioned at bind time wherever the pod lands."""

    meta: Metadata
    provisioner: str = "volcano.tpu/dynamic"
    volume_binding_mode: str = "WaitForFirstConsumer"


@dataclass
class PersistentVolume:
    """A provisioned volume.  ``node_affinity`` is a node-label selector
    (empty: reachable from every node, network storage); a local volume
    pins its claims to the nodes it matches."""

    meta: Metadata
    capacity: str = ""
    storage_class: str = ""
    node_affinity: Dict[str, str] = field(default_factory=dict)
    claim_ref: str = ""        # bound PVC key; empty while Available
    provisioned: bool = False  # created at bind (vs pre-created)

    @property
    def phase(self) -> str:
        return "Bound" if self.claim_ref else "Available"

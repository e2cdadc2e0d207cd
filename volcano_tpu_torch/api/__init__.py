from volcano_tpu_torch.api.objects import (
    POD_GROUP_KEY,
    Affinity,
    Metadata,
    Node,
    NodeCondition,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    PodDisruptionBudget,
    PodGroup,
    PodGroupCondition,
    PodGroupStatus,
    PodSpec,
    PriorityClass,
    Queue,
    StorageClass,
    Taint,
    Toleration,
)
from volcano_tpu_torch.api.resource import (
    MIN_MEMORY,
    MIN_MILLI_CPU,
    MIN_SCALAR,
    Resource,
    parse_quantity,
)
from volcano_tpu_torch.api.types import PodGroupPhase, PodPhase, TaskStatus

__all__ = [n for n in dir() if not n.startswith("_")]

"""Shared enums: task status, pod and PodGroup phases (the port's copy of
the parts of ``volcano_tpu/api/types.py`` the scheduler reads)."""

from __future__ import annotations

import enum


class TaskStatus(enum.IntFlag):
    PENDING = 1 << 0
    ALLOCATED = 1 << 1
    PIPELINED = 1 << 2
    BINDING = 1 << 3
    BOUND = 1 << 4
    RUNNING = 1 << 5
    RELEASING = 1 << 6
    SUCCEEDED = 1 << 7
    FAILED = 1 << 8
    UNKNOWN = 1 << 9


#: statuses whose resources are charged against the node
ALLOCATED_STATUSES = (
    TaskStatus.BOUND | TaskStatus.BINDING | TaskStatus.RUNNING | TaskStatus.ALLOCATED
)


def allocated_status(status: TaskStatus) -> bool:
    return bool(status & ALLOCATED_STATUSES)


class PodPhase(str, enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"


def task_status_of_pod(pod) -> TaskStatus:
    """A pod's phase + deletion mark + node assignment as a TaskStatus."""
    phase = pod.phase
    if phase == PodPhase.RUNNING:
        return TaskStatus.RELEASING if pod.deleting else TaskStatus.RUNNING
    if phase == PodPhase.PENDING:
        if pod.deleting:
            return TaskStatus.RELEASING
        return TaskStatus.BOUND if pod.node_name else TaskStatus.PENDING
    if phase == PodPhase.SUCCEEDED:
        return TaskStatus.SUCCEEDED
    if phase == PodPhase.FAILED:
        return TaskStatus.FAILED
    return TaskStatus.UNKNOWN


class PodGroupPhase(str, enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    UNKNOWN = "Unknown"
    INQUEUE = "Inqueue"

"""Cluster event recorder, the Kubernetes Events analogue.

The port's copy of ``volcano_tpu/events.py``.  The scheduler cache records
"Scheduled" on a bind, "Evict" on an eviction and an "Unschedulable"
warning on a PodGroup's condition transitions (KB/pkg/scheduler/cache/
cache.go:443,401,467).  Events are store objects of kind "Event", so every
reader of the store sees the same stream.

Aggregation follows the Kubernetes pattern: a repeat of (involved, reason,
message) bumps ``count`` on the existing Event instead of growing the
store without bound.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from volcano_tpu_torch.api.objects import Metadata, new_uid

NORMAL = "Normal"
WARNING = "Warning"


def scheduled_message(task_key: str, hostname: str) -> str:
    """The bind Event's message (cache.go:443), one source for the
    synchronous and the applier paths."""
    return f"Successfully assigned {task_key} to {hostname}"


def evicted_message(reason: str) -> str:
    """The eviction Event's message (cache.go:401)."""
    return f"Evicted for {reason}"


@dataclass
class ClusterEvent:
    meta: Metadata
    involved: Tuple[str, str] = ("", "")  # (kind, namespace/name)
    reason: str = ""
    message: str = ""
    type: str = NORMAL
    count: int = 1


def record_op(index, involved_kind, involved_key, reason, message, type=NORMAL):
    """The batched counterpart of ``record``: returns ``(bulk_op, meta)``,
    where ``bulk_op`` is a ``Store.bulk`` operation that creates the Event
    or bumps its count in the caller's aggregation ``index``, and ``meta``
    is ``(index_key, event, is_new)``.  A new Event joins the index only
    after the store confirms the create; on a failed op the caller pops
    ``index[index_key]`` so that the next occurrence creates afresh."""
    idx_key = (involved_kind, involved_key, reason, message)
    ev = index.get(idx_key)
    if ev is not None:
        ev.count += 1
        return ({"op": "patch", "kind": "Event", "key": ev.meta.key,
                 "fields": {"count": ev.count}}, (idx_key, ev, False))
    ev = ClusterEvent(meta=Metadata(name=new_uid("event"), namespace=""),
                      involved=(involved_kind, involved_key), reason=reason,
                      message=message, type=type)
    return {"op": "create", "kind": "Event", "object": ev}, (idx_key, ev, True)


def record(store, involved_kind: str, involved_key: str, reason: str,
           message: str, type: str = NORMAL) -> ClusterEvent:
    """Record (or aggregate) an Event about an object."""
    # O(1) aggregation index, attached to the store on first use
    idx = getattr(store, "_event_index", None)
    if idx is None:
        idx = store._event_index = {}
    key = (involved_kind, involved_key, reason, message)
    ev = idx.get(key)
    if ev is not None and store.get("Event", ev.meta.key) is not None:
        ev.count += 1
        return store.update("Event", ev)
    ev = ClusterEvent(meta=Metadata(name=new_uid("event"), namespace=""),
                      involved=(involved_kind, involved_key), reason=reason,
                      message=message, type=type)
    idx[key] = ev
    return store.create("Event", ev)


def record_once(store, involved_kind: str, involved_key: str, reason: str,
                message: str, type: str = NORMAL) -> ClusterEvent:
    """``record``, but a repeat of an identical (involved, reason, message)
    changes nothing: a steady condition re-emitted every cycle (a parked
    best-effort task) leaves the store untouched, so the cluster can
    quiesce."""
    idx = getattr(store, "_event_index", None)
    if idx is not None:
        ev = idx.get((involved_kind, involved_key, reason, message))
        if ev is not None and store.get("Event", ev.meta.key) is not None:
            return ev
    return record(store, involved_kind, involved_key, reason, message, type)


def events_for(store, involved_kind: str, involved_key: str):
    """All Events about one object, oldest first."""
    out = [ev for ev in store.items("Event")
           if ev.involved == (involved_kind, involved_key)]
    # uids are a zero-padded monotonic counter, so they order by creation
    # even after a count bump moved an old Event's resource version
    out.sort(key=lambda e: e.meta.uid)
    return out

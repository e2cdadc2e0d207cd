"""Columnar decision segments: one unit for a whole cycle's output.

The port's copy of ``volcano_tpu/store/segment.py`` without the server's
log blocks.  A ``DecisionSegment`` holds parallel columns (pod keys, node
ids, reason codes) over interned string tables, built straight from the
fast cycle's solve outputs and handed to the async applier as ONE queue
entry; ``Store.apply_segment`` applies it (a patch per row, then one
Scheduled or Evict Event per row that landed).  The segment reserves the
uid block its Events draw their names from (``event_name``), so that a
resubmitted segment is recognised and creates no second Event.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from volcano_tpu_torch.api.objects import Metadata, reserve_uids
from volcano_tpu_torch.events import (  # noqa: F401  (NORMAL / WARNING / messages re-exported)
    NORMAL,
    WARNING,
    ClusterEvent,
    evicted_message,
    scheduled_message,
)

#: reasons of the two Event sections a segment carries
BIND_REASON = "Scheduled"
EVICT_REASON = "Evict"


class DecisionSegment:
    """One cycle's binds and evictions in columnar form.

    ``bind_keys[i]`` is placed on ``node_table[bind_nodes[i]]``;
    ``evict_keys[j]`` is evicted for ``reason_table[evict_reasons[j]]``.
    ``ev_token`` / ``ev_start`` name the reserved uid block the Events of
    the rows take their names from, binds first, then evictions."""

    __slots__ = (
        "bind_keys", "bind_nodes", "node_table",
        "evict_keys", "evict_reasons", "reason_table",
        "ev_token", "ev_start", "_hosts", "_reasons",
    )

    def __init__(self, bind_keys, bind_nodes, node_table,
                 evict_keys, evict_reasons, reason_table, ev_token, ev_start):
        self.bind_keys: List[str] = bind_keys
        self.bind_nodes: List[int] = bind_nodes
        self.node_table: List[str] = node_table
        self.evict_keys: List[str] = evict_keys
        self.evict_reasons: List[int] = evict_reasons
        self.reason_table: List[str] = reason_table
        self.ev_token: str = ev_token
        self.ev_start: int = ev_start
        self._hosts: Optional[List[str]] = None
        self._reasons: Optional[List[str]] = None

    @classmethod
    def build(cls, bind_keys: List[str], bind_nodes: List[int], node_table: List[str],
              evicts: Optional[List[Tuple[str, str]]] = None) -> "DecisionSegment":
        """A segment from publish's columns; the (few) evictions, (pod_key,
        reason) pairs, are interned here."""
        evict_keys: List[str] = []
        evict_reasons: List[int] = []
        reason_table: List[str] = []
        if evicts:
            interned: Dict[str, int] = {}
            for key, reason in evicts:
                idx = interned.get(reason)
                if idx is None:
                    idx = interned[reason] = len(reason_table)
                    reason_table.append(reason)
                evict_keys.append(key)
                evict_reasons.append(idx)
        token, start = reserve_uids("event", len(bind_keys) + len(evict_keys))
        return cls(bind_keys, bind_nodes, node_table,
                   evict_keys, evict_reasons, reason_table, token, start)

    # -- derived columns (memoized) ------------------------------------------

    @property
    def bind_hosts(self) -> List[str]:
        if self._hosts is None:
            table = self.node_table
            self._hosts = [table[i] for i in self.bind_nodes]
        return self._hosts

    @property
    def evict_reason_strs(self) -> List[str]:
        if self._reasons is None:
            table = self.reason_table
            self._reasons = [table[i] for i in self.evict_reasons]
        return self._reasons

    @property
    def empty(self) -> bool:
        return not self.bind_keys and not self.evict_keys

    def bind_pairs(self) -> List[Tuple[str, str]]:
        return list(zip(self.bind_keys, self.bind_hosts))

    def evict_pairs(self) -> List[Tuple[str, str]]:
        return list(zip(self.evict_keys, self.evict_reason_strs))

    # -- wire form -------------------------------------------------------------

    def to_wire(self) -> Dict[str, Any]:
        return {
            "op": "segment",
            "binds": {"keys": self.bind_keys, "nodes": self.bind_nodes,
                      "node_table": self.node_table},
            "evicts": {"keys": self.evict_keys, "reasons": self.evict_reasons,
                       "reason_table": self.reason_table},
            "events": {"token": self.ev_token, "start": self.ev_start},
        }

    @classmethod
    def from_wire(cls, op: Dict[str, Any]) -> "DecisionSegment":
        b = op.get("binds") or {}
        e = op.get("evicts") or {}
        ev = op.get("events") or {}
        return cls(b.get("keys") or [], b.get("nodes") or [], b.get("node_table") or [],
                   e.get("keys") or [], e.get("reasons") or [], e.get("reason_table") or [],
                   str(ev.get("token") or ""), int(ev.get("start") or 0))


def event_name(token: str, idx: int) -> str:
    """The Event name of uid-block slot ``idx``: the shape ``new_uid("event")``
    gives, so segment Events sort and aggregate as per-object ones do."""
    return f"event-{token}-{idx:08d}"


def materialize_event(name: str, involved_key: str, reason: str, message: str,
                      type_: str, rv: int, stamp: float) -> ClusterEvent:
    """The ClusterEvent a segment row denotes; uid == name, so
    ``events_for``'s uid order is creation order."""
    return ClusterEvent(
        meta=Metadata(name=name, namespace="", uid=name,
                      resource_version=rv, creation_timestamp=stamp),
        involved=("Pod", involved_key), reason=reason, message=message, type=type_)

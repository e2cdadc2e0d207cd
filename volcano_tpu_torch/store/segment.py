"""Columnar decision segments: one unit for a whole cycle's output.

The port's copy of ``volcano_tpu/store/segment.py``.  A ``DecisionSegment`` holds parallel columns (pod keys, node
ids, reason codes) over interned string tables, built straight from the
fast cycle's solve outputs and handed to the async applier as ONE queue
entry; ``Store.apply_segment`` applies it (a patch per row, then one
Scheduled or Evict Event per row that landed).  The segment reserves the
uid block its Events draw their names from (``event_name``), so that a
resubmitted segment is recognised and creates no second Event.

The server half: ``Store.apply_segment_lazy`` stages a segment's rows
without touching a live object, and the StoreServer logs each section as
one ``PatchLogBlock`` or ``EventLogBlock``, whose rows expand into watch
entries (``encode_event_row``: the codec's encoding, built directly) only
when a watcher reads them.
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


def encode_event_row(name: str, involved_key: str, reason: str,
                     message: str, type_: str, rv: int,
                     stamp: float) -> Dict[str, Any]:
    """The codec encoding of ``materialize_event(...)``, built directly:
    field for field ``codec.encode(ClusterEvent(...))``
    (``tests/test_torch_columnar_server.py`` holds the byte equality)."""
    return {
        "meta": {
            "name": name, "namespace": "", "uid": name,
            "labels": {}, "annotations": {},
            "resource_version": rv, "creation_timestamp": stamp,
            "owner": None,
        },
        "involved": ["Pod", involved_key],
        "reason": reason,
        "message": message,
        "type": type_,
        "count": 1,
    }


# -- server-side columnar log blocks ----------------------------------------


class PatchLogBlock:
    """A run of same-field scalar patches in the server's event log: one
    block instead of N encoded-dict entries.  Rows expand lazily into the
    dicts the per-object patch path logs (``object``: the pre-encoding
    plus the delta, ``old``: the shared pre-encoding)."""

    kind = "Pod"
    type = "Updated"

    __slots__ = ("field", "keys", "values", "pre", "rv0", "seq0", "post",
                 "_rows")

    def __init__(self, field: str, keys: List[str], values: List[Any],
                 pre: List[Dict[str, Any]], rv0: int):
        self.field = field
        self.keys = keys
        self.values = values  # parallel to keys (per-row scalars)
        self.pre = pre
        self.rv0 = rv0  # resource_version of row 0
        self.seq0 = 0  # seq of row 0, stamped when appended to the log
        self.post: List[Optional[Dict[str, Any]]] = [None] * len(keys)
        self._rows: Optional[List[Dict[str, Any]]] = None

    def __len__(self) -> int:
        return len(self.keys)

    def materialize_enc(self, i: int) -> Dict[str, Any]:
        enc = self.post[i]
        if enc is None:
            enc = dict(self.pre[i])
            meta = dict(enc["meta"])
            meta["resource_version"] = self.rv0 + i
            enc["meta"] = meta
            enc[self.field] = self.values[i]
            self.post[i] = enc
        return enc

    def wire_rows(self, a: int, b: int) -> List[Dict[str, Any]]:
        rows = self._rows
        if rows is None:
            seq0, kind, type_, pre = self.seq0, self.kind, self.type, self.pre
            rows = self._rows = [
                {"seq": seq0 + i, "kind": kind, "type": type_,
                 "object": self.materialize_enc(i), "old": pre[i]}
                for i in range(len(self.keys))
            ]
        return rows[a:b]


class EventLogBlock:
    """A run of segment-born Event creates in the server's log.  Rows
    never exist as ClusterEvent objects here — names, messages, and
    encodings derive from the columns on demand (``Store`` materializes
    the objects separately, only when an Event read asks for them)."""

    kind = "Event"
    type = "Added"

    __slots__ = ("reason", "ev_type", "token", "uid_idx", "inv_keys",
                 "values", "rv0", "stamp", "seq0", "encs", "_rows")

    def __init__(self, reason: str, token: str, uid_idx: List[int],
                 inv_keys: List[str], values: List[str], rv0: int,
                 stamp: float):
        self.reason = reason
        self.ev_type = WARNING if reason == EVICT_REASON else NORMAL
        self.token = token
        self.uid_idx = uid_idx  # uid-block slot per row
        self.inv_keys = inv_keys
        self.values = values  # hostnames (binds) / reason strings (evicts)
        self.rv0 = rv0
        self.stamp = stamp
        self.seq0 = 0
        self.encs: List[Optional[Dict[str, Any]]] = [None] * len(inv_keys)
        self._rows: Optional[List[Dict[str, Any]]] = None

    def __len__(self) -> int:
        return len(self.inv_keys)

    def name(self, i: int) -> str:
        return event_name(self.token, self.uid_idx[i])

    def key(self, i: int) -> str:
        return f"/{self.name(i)}"  # Metadata.key with namespace ""

    def message(self, i: int) -> str:
        if self.reason == BIND_REASON:
            return scheduled_message(self.inv_keys[i], self.values[i])
        return evicted_message(self.values[i])

    def materialize(self, i: int) -> ClusterEvent:
        return materialize_event(
            self.name(i), self.inv_keys[i], self.reason, self.message(i),
            self.ev_type, self.rv0 + i, self.stamp,
        )

    def materialize_enc(self, i: int) -> Dict[str, Any]:
        enc = self.encs[i]
        if enc is None:
            enc = encode_event_row(
                self.name(i), self.inv_keys[i], self.reason,
                self.message(i), self.ev_type, self.rv0 + i, self.stamp,
            )
            self.encs[i] = enc
        return enc

    def wire_rows(self, a: int, b: int) -> List[Dict[str, Any]]:
        rows = self._rows
        if rows is None:
            seq0, kind, type_ = self.seq0, self.kind, self.type
            rows = self._rows = [
                {"seq": seq0 + i, "kind": kind, "type": type_,
                 "object": self.materialize_enc(i), "old": None}
                for i in range(len(self.inv_keys))
            ]
        return rows[a:b]

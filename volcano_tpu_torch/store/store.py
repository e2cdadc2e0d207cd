"""In-memory watchable object store — the "API server" of the port.

The port's own copy of ``volcano_tpu/store/store.py``, cut to the verbs the
express cycle uses: typed buckets keyed by namespace/name, a monotonically
increasing resource version, watch queues of add/update/delete events, and
no-op suppression (a write that changes nothing bumps no version and
notifies no watcher — quiescence relies on it), the compare-and-swap
``update_cas`` (the leader lease's write), a lineage ``uid`` (a mirror
checkpoint tells "this store restarted" from "another store whose version
counter happens to align"), and ``apply_segment``, the
in-process apply of a columnar decision segment (``store/segment.py``)
with its resubmit dedupe.  Event objects keep no shadow copy
(``SHADOWLESS_KINDS``).  No WAL, lazy segment apply, digests or remote
transport (ROADMAP items 11 and 13).
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import threading
import time
import uuid
from collections import OrderedDict, defaultdict, deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, Iterator, List, Optional

_MISSING = object()

# -- fast structural deep clone for API objects ------------------------------

_ATOMIC = {str, int, float, bool, type(None), bytes}
_FIELDS: Dict[type, Optional[tuple]] = {}


def _fields_of(t: type, obj: Any) -> Optional[tuple]:
    if issubclass(t, enum.Enum):
        _ATOMIC.add(t)
        return ()
    if dataclasses.is_dataclass(t):
        names = tuple(f.name for f in dataclasses.fields(t))
    elif getattr(t, "__slots__", None) is not None and not hasattr(obj, "__dict__"):
        names = tuple(t.__slots__)
    else:
        names = None
    _FIELDS[t] = names
    return names


def deep_clone(o: Any) -> Any:
    """Structural deep copy of dataclass/slots objects of primitives, dicts,
    lists and tuples (``copy.deepcopy`` for anything else)."""
    t = o.__class__
    if t in _ATOMIC:
        return o
    if t is dict:
        return {k: deep_clone(v) for k, v in o.items()}
    if t is list:
        return [deep_clone(v) for v in o]
    if t is tuple:
        return tuple(deep_clone(v) for v in o)
    if t in _FIELDS:
        fields = _FIELDS[t]
    else:
        fields = _fields_of(t, o)
        if t in _ATOMIC:
            return o
    if fields is None:
        return copy.deepcopy(o)
    new = object.__new__(t)
    for f in fields:
        setattr(new, f, deep_clone(getattr(o, f)))
    return new


class EventType(str, enum.Enum):
    ADDED = "Added"
    UPDATED = "Updated"
    DELETED = "Deleted"


class Conflict(Exception):
    """Optimistic-concurrency failure: the object changed since it was read
    (the API server's 409 on a stale resourceVersion)."""


class PreconditionFailed(Exception):
    """A patch's ``when`` clause did not match the stored object."""


@dataclass
class Event:
    kind: str
    type: EventType
    obj: Any
    old: Any = None


def _walk(obj: Any, dotted: str):
    parts = dotted.split(".")
    cur = obj
    for p in parts[:-1]:
        if not hasattr(cur, p):
            raise AttributeError(f"no field {p!r} on path {dotted!r}")
        cur = getattr(cur, p)
    if not hasattr(cur, parts[-1]):
        raise AttributeError(f"no field {parts[-1]!r} on path {dotted!r}")
    return cur, parts[-1]


class Store:
    """Typed object buckets + watch queues."""

    def __init__(self):
        #: lineage identity, checked by a mirror checkpoint's restore
        self.uid = uuid.uuid4().hex
        self._objects: Dict[str, Dict[str, Any]] = defaultdict(dict)
        # last-notified state per object: no-op detection and Event.old
        self._shadow: Dict[str, Dict[str, Any]] = defaultdict(dict)
        self._watchers: Dict[str, List[Deque[Event]]] = defaultdict(list)
        self._rv = 0
        # (ev_token, ev_start) of recently applied decision segments: the
        # reserved uid block identifies a segment, so a resubmitted one is
        # recognised and its Event rows dedupe against those that landed
        self._applied_segments: OrderedDict = OrderedDict()
        # the async applier writes from its own thread while the owning
        # thread reads and writes
        self._mu = threading.RLock()

    def _watched(self, kind: str) -> bool:
        return bool(self._watchers[kind])

    @property
    def resource_version(self) -> int:
        return self._rv

    #: kinds that keep no shadow copy: records nobody diff-suppresses (a
    #: count bump takes the full update() path); a Scheduled Event a bind
    #: would otherwise pay a deep clone per create
    SHADOWLESS_KINDS = frozenset({"Event"})

    def _notify(self, ev: Event) -> None:
        for q in self._watchers[ev.kind]:
            q.append(ev)
        # every kind but the shadowless ones is shadowed, watched or not:
        # update() compares against it to suppress no-op writes
        if ev.type == EventType.DELETED:
            self._shadow[ev.kind].pop(ev.obj.meta.key, None)
        elif ev.kind not in self.SHADOWLESS_KINDS:
            self._shadow[ev.kind][ev.obj.meta.key] = deep_clone(ev.obj)

    def create(self, kind: str, obj: Any) -> Any:
        with self._mu:
            key = obj.meta.key
            if key in self._objects[kind]:
                raise KeyError(f"{kind} {key} already exists")
            self._rv += 1
            obj.meta.resource_version = self._rv
            if not obj.meta.creation_timestamp:
                obj.meta.creation_timestamp = time.time()
            self._objects[kind][key] = obj
            self._notify(Event(kind, EventType.ADDED, obj))
            return obj

    def update(self, kind: str, obj: Any) -> Any:
        with self._mu:
            key = obj.meta.key
            if key not in self._objects[kind]:
                raise KeyError(f"{kind} {key} not found")
            old = self._shadow[kind].get(key)
            if old is not None and old == obj:
                return obj
            self._rv += 1
            obj.meta.resource_version = self._rv
            self._objects[kind][key] = obj
            self._notify(Event(kind, EventType.UPDATED, obj, old))
            return obj

    def update_cas(self, kind: str, obj: Any, expected_rv: int) -> Any:
        """Compare-and-swap update: succeeds only while the stored object's
        resource version still equals ``expected_rv``; raises Conflict
        otherwise (two candidates racing for one lease cannot both win)."""
        with self._mu:
            current = self._objects[kind].get(obj.meta.key)
            if current is None:
                raise KeyError(f"{kind} {obj.meta.key} not found")
            if current.meta.resource_version != expected_rv:
                raise Conflict(f"{kind} {obj.meta.key}: expected rv {expected_rv}, "
                               f"have {current.meta.resource_version}")
            return self.update(kind, obj)

    def patch(self, kind: str, key: str, fields: Dict[str, Any],
              when: Optional[Dict[str, Any]] = None) -> Any:
        """Set (possibly dotted) fields on the stored object.  ``when`` maps
        dotted paths to expected values; a mismatch raises
        PreconditionFailed and writes nothing."""
        with self._mu:
            obj = self._objects[kind].get(key)
            if obj is None:
                raise KeyError(f"{kind} {key} not found")
            if when:
                for k, expect in when.items():
                    parent, leaf = _walk(obj, k)
                    got = getattr(parent, leaf)
                    if got != expect:
                        raise PreconditionFailed(
                            f"{kind} {key}: {k} is {got!r}, wanted {expect!r}")
            paths = {k: k.split(".") for k in fields}
            for k in fields:
                _walk(obj, k)
            shadow = self._shadow[kind].get(key)
            if shadow is None or any(p[0] == "meta" for p in paths.values()):
                for k, v in fields.items():
                    parent, leaf = _walk(obj, k)
                    setattr(parent, leaf, v)
                return self.update(kind, obj)

            def _leaf(root, parts):
                for p in parts[:-1]:
                    root = getattr(root, p)
                return getattr(root, parts[-1], _MISSING)

            if all(_leaf(obj, paths[k]) == v and _leaf(shadow, paths[k]) == v
                   for k, v in fields.items()):
                return obj  # no-op
            for k, v in fields.items():
                parent, leaf = _walk(obj, k)
                setattr(parent, leaf, v)
            self._rv += 1
            obj.meta.resource_version = self._rv
            # copy-on-write shadow: only the patched path is cloned
            new_shadow = copy.copy(shadow)
            new_shadow.meta = copy.copy(shadow.meta)
            new_shadow.meta.resource_version = self._rv
            for k, v in fields.items():
                cur = new_shadow
                for p in paths[k][:-1]:
                    child = copy.copy(getattr(cur, p))
                    setattr(cur, p, child)
                    cur = child
                setattr(cur, paths[k][-1], deep_clone(v))
            ev = Event(kind, EventType.UPDATED, obj, shadow)
            for q in self._watchers[kind]:
                q.append(ev)
            self._shadow[kind][key] = new_shadow
            return obj

    def bulk(self, ops: List[Dict[str, Any]]) -> List[Optional[str]]:
        """Apply N mutations in order; one error string (or None) per op:
        {"op": "create"|"update", "kind", "object"} / {"op": "patch", "kind",
        "key", "fields", "when"?} / {"op": "delete", "kind", "key"}."""
        results: List[Optional[str]] = []
        for op in ops:
            try:
                verb, kind = op["op"], op["kind"]
                if verb == "create":
                    self.create(kind, op["object"])
                elif verb == "update":
                    self.update(kind, op["object"])
                elif verb == "patch":
                    self.patch(kind, op["key"], op["fields"], when=op.get("when"))
                elif verb == "delete":
                    self.delete(kind, op["key"])
                else:
                    raise ValueError(f"unknown bulk op {verb!r}")
                results.append(None)
            except KeyError as e:
                results.append(f"NotFound: {e}")
            except PreconditionFailed as e:
                results.append(f"PreconditionFailed: {e}")
            except Exception as e:  # noqa: BLE001 — per-op isolation
                results.append(repr(e))
        return results

    # -- columnar segments -------------------------------------------------------

    #: recently applied segments remembered for the resubmit dedupe
    SEGMENT_DEDUP_CAP = 1024

    def _note_segment(self, seg) -> bool:
        """Record ``seg``'s reserved uid block as applied; True when it was
        seen before (a resubmit).  Must run under ``_mu``."""
        key = (seg.ev_token, seg.ev_start)
        resubmit = key in self._applied_segments
        self._applied_segments[key] = True
        self._applied_segments.move_to_end(key)
        while len(self._applied_segments) > self.SEGMENT_DEDUP_CAP:
            self._applied_segments.popitem(last=False)
        return resubmit

    def apply_segment(self, seg) -> Dict[str, Any]:
        """Apply one decision segment (``store/segment.py``): the bind
        patches, the eviction patches, then one Scheduled or Evict Event per
        row that landed, the same store writes and watch events as the
        per-object bulk path.  Returns ``{"binds": [[row, err], ...],
        "evicts": [...], "timings": {"binds_s", "evicts_s", "events_s"}}``
        with sparse per-row errors, the bulk verb's isolation.  A
        resubmitted segment (same uid block) creates no Event twice."""
        from volcano_tpu_torch.store import segment as segmod

        hosts = seg.bind_hosts
        reasons = seg.evict_reason_strs
        errs_b: List[List[Any]] = []
        errs_e: List[List[Any]] = []
        ev_rows: List[tuple] = []  # (uid slot, involved key, reason, message, type)
        with self._mu:
            resubmit = self._note_segment(seg)
        # a lock hold per row, as Store.bulk: readers interleave between rows
        t0 = time.perf_counter()
        for i, key in enumerate(seg.bind_keys):
            try:
                self.patch("Pod", key, {"node_name": hosts[i]})
            except KeyError as e:
                errs_b.append([i, f"NotFound: {e}"])
                continue
            except Exception as e:  # noqa: BLE001 — per-row isolation
                errs_b.append([i, repr(e)])
                continue
            ev_rows.append((seg.ev_start + i, key, segmod.BIND_REASON,
                            segmod.scheduled_message(key, hosts[i]), segmod.NORMAL))
        t1 = time.perf_counter()
        n_b = len(seg.bind_keys)
        for j, key in enumerate(seg.evict_keys):
            try:
                self.patch("Pod", key, {"deleting": True})
            except KeyError as e:
                errs_e.append([j, f"NotFound: {e}"])
                continue
            except Exception as e:  # noqa: BLE001 — per-row isolation
                errs_e.append([j, repr(e)])
                continue
            ev_rows.append((seg.ev_start + n_b + j, key, segmod.EVICT_REASON,
                            segmod.evicted_message(reasons[j]), segmod.WARNING))
        t2 = time.perf_counter()
        events = self._objects["Event"]
        for slot, key, reason, message, type_ in ev_rows:
            name = segmod.event_name(seg.ev_token, slot)
            if resubmit and f"/{name}" in events:
                continue  # this row landed with the first submission
            ev = segmod.materialize_event(name, key, reason, message, type_,
                                          rv=0, stamp=0.0)
            try:
                self.create("Event", ev)
            except KeyError:
                # the row exists already (a resubmit past the dedupe window)
                continue
        t3 = time.perf_counter()
        return {"binds": errs_b, "evicts": errs_e,
                "timings": {"binds_s": t1 - t0, "evicts_s": t2 - t1,
                            "events_s": t3 - t2}}

    def delete(self, kind: str, key: str) -> Optional[Any]:
        with self._mu:
            obj = self._objects[kind].pop(key, None)
            if obj is not None:
                self._notify(Event(kind, EventType.DELETED, obj))
            return obj

    def get(self, kind: str, key: str) -> Optional[Any]:
        return self._objects[kind].get(key)

    def list(self, kind: str) -> List[Any]:
        with self._mu:
            return list(self._objects[kind].values())

    def items(self, kind: str) -> Iterator[Any]:
        return iter(self.list(kind))

    def watch(self, kind: str) -> Deque[Event]:
        """Subscribe to a kind; returns the event queue to drain."""
        q: Deque[Event] = deque()
        self._watchers[kind].append(q)
        return q

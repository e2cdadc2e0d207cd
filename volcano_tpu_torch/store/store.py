"""In-memory watchable object store — the "API server" of the port.

The port's own copy of ``volcano_tpu/store/store.py``, cut to the verbs the
express cycle uses: typed buckets keyed by namespace/name, a monotonically
increasing resource version, watch queues of add/update/delete events, and
no-op suppression (a write that changes nothing bumps no version and
notifies no watcher — quiescence relies on it).  No WAL, segments,
digests or remote transport.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import threading
from collections import defaultdict, deque
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
        self._objects: Dict[str, Dict[str, Any]] = defaultdict(dict)
        # last-notified state per object: no-op detection and Event.old
        self._shadow: Dict[str, Dict[str, Any]] = defaultdict(dict)
        self._watchers: Dict[str, List[Deque[Event]]] = defaultdict(list)
        self._rv = 0
        self._mu = threading.RLock()

    @property
    def resource_version(self) -> int:
        return self._rv

    def _notify(self, ev: Event) -> None:
        for q in self._watchers[ev.kind]:
            q.append(ev)
        if ev.type == EventType.DELETED:
            self._shadow[ev.kind].pop(ev.obj.meta.key, None)
        else:
            self._shadow[ev.kind][ev.obj.meta.key] = deep_clone(ev.obj)

    def create(self, kind: str, obj: Any) -> Any:
        with self._mu:
            key = obj.meta.key
            if key in self._objects[kind]:
                raise KeyError(f"{kind} {key} already exists")
            self._rv += 1
            obj.meta.resource_version = self._rv
            if not obj.meta.creation_timestamp:
                import time

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

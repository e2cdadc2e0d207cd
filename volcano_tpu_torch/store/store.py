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
with its resubmit dedupe, and ``apply_segment_lazy``, the StoreServer's
half of the columnar wire: a segment's rows are staged in a lazy overlay
and folded into the live objects by the first verb that reads or writes
their key (``_materialize``).  Event objects keep no shadow copy
(``SHADOWLESS_KINDS``).  Every verb keeps the incremental state digest
(``vtaudit.py``) under ``_mu`` when the audit is armed
(``VOLCANO_TPU_AUDIT``, on by default, read at construction): ``_digest``,
served by ``digest_payload`` / ``digest_buckets`` / ``digest_objects``,
against ``recompute_digest``'s ground truth.  The durability
(``store/wal.py``) and the HTTP transport (``store/server.py``,
``store/client.py``) sit around it.
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
    # atomic members (most of an object's) skip the recursive call
    if t is dict:
        return {k: v if v.__class__ in _ATOMIC else deep_clone(v) for k, v in o.items()}
    if t is list:
        return [v if v.__class__ in _ATOMIC else deep_clone(v) for v in o]
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
        v = getattr(o, f)
        setattr(new, f, v if v.__class__ in _ATOMIC else deep_clone(v))
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
    #: a copy-on-write patch's field map (possibly dotted paths): lets the
    #: StoreServer update its encoded-object cache by delta
    fields: Any = None
    #: remote transport only (``RemoteStore.poll``): the wire encoding of
    #: the post-state, carried from the watch entry
    enc: Any = None


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
        # the lazy columnar overlay (apply_segment_lazy): per kind, field
        # patches and creates acknowledged but not yet applied to the live
        # objects, key -> (fields, rv) / (log block, row).  Every verb
        # materializes the keys it touches first, so the per-object work
        # is paid on the first read, not at the segment's apply
        self._lazy_patch: Dict[str, Dict[str, Any]] = defaultdict(dict)
        self._lazy_create: Dict[str, Dict[str, Any]] = defaultdict(dict)
        self._rv = 0
        # (ev_token, ev_start) of recently applied decision segments: the
        # reserved uid block identifies a segment, so a resubmitted one is
        # recognised and its Event rows dedupe against those that landed
        self._applied_segments: OrderedDict = OrderedDict()
        # the incremental state digest (vtaudit.py): per-object digests and
        # (kind, namespace) bucket sums, kept by every mutating verb under
        # _mu; None when the audit is disarmed
        from volcano_tpu_torch import vtaudit

        self._digest = vtaudit.DigestTable() if vtaudit.enabled() else None
        # the async applier writes from its own thread while the owning
        # thread reads and writes
        self._mu = threading.RLock()

    def __getstate__(self):
        # the lock is process-local; lazily pending segment rows
        # materialize first so that the pickle holds plain objects
        self.materialize_all()
        state = self.__dict__.copy()
        del state["_mu"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.__dict__.setdefault("_lazy_patch", defaultdict(dict))
        self.__dict__.setdefault("_lazy_create", defaultdict(dict))
        self.__dict__.setdefault("_applied_segments", OrderedDict())
        from volcano_tpu_torch import vtaudit

        if not vtaudit.enabled():
            self.__dict__["_digest"] = None
        elif self.__dict__.get("_digest") is None:
            # pickled by a disarmed life: rebuild from the objects
            self.__dict__["_digest"] = vtaudit.table_from_objects(
                (kind, obj) for kind, bucket in self._objects.items()
                for obj in bucket.values())
        self._mu = threading.RLock()

    def _watched(self, kind: str) -> bool:
        return bool(self._watchers[kind])

    @property
    def resource_version(self) -> int:
        return self._rv

    def _advance_rv(self, n: int = 1) -> int:
        """Consume ``n`` resource versions and return the last one (the
        caller's block is ``last - n + 1 .. last``)."""
        self._rv += n
        return self._rv

    # -- the lazy segment overlay ----------------------------------------------

    def _materialize(self, kind: str, key: str) -> None:
        """Fold the pending segment rows of ``key`` into the live object and
        its no-op-suppression shadow.  Every verb that reads or writes the
        key calls it first.  Must run under ``_mu``."""
        lp = self._lazy_patch.get(kind)
        if lp:
            entry = lp.pop(key, None)
            if entry is not None:
                fields, rv = entry
                obj = self._objects[kind][key]
                for name, v in fields.items():
                    setattr(obj, name, v)
                obj.meta.resource_version = rv
                shadow = self._shadow[kind].get(key)
                if shadow is not None:
                    new_shadow = copy.copy(shadow)
                    new_shadow.meta = copy.copy(shadow.meta)
                    new_shadow.meta.resource_version = rv
                    for name, v in fields.items():
                        setattr(new_shadow, name, deep_clone(v))
                    self._shadow[kind][key] = new_shadow
        lc = self._lazy_create.get(kind)
        if lc:
            entry = lc.pop(key, None)
            if entry is not None:
                block, i = entry
                self._objects[kind][key] = block.materialize(i)

    def _materialize_kind(self, kind: str) -> None:
        lp = self._lazy_patch.get(kind)
        lc = self._lazy_create.get(kind)
        if not lp and not lc:
            return
        for key in list(lp or ()):
            self._materialize(kind, key)
        for key in list(lc or ()):
            self._materialize(kind, key)

    def materialize_all(self) -> None:
        """Materialize every pending segment row (pickling, state flushes)."""
        with self._mu:
            for kind in list(self._lazy_patch) + list(self._lazy_create):
                self._materialize_kind(kind)

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
            lc = self._lazy_create.get(kind)
            if key in self._objects[kind] or (lc and key in lc):
                raise KeyError(f"{kind} {key} already exists")
            obj.meta.resource_version = self._advance_rv()
            if not obj.meta.creation_timestamp:
                obj.meta.creation_timestamp = time.time()
            self._objects[kind][key] = obj
            dg = self._digest
            if dg is not None:
                dg.set_obj(kind, key, obj)
            self._notify(Event(kind, EventType.ADDED, obj))
            return obj

    def update(self, kind: str, obj: Any) -> Any:
        with self._mu:
            key = obj.meta.key
            self._materialize(kind, key)
            if key not in self._objects[kind]:
                raise KeyError(f"{kind} {key} not found")
            old = self._shadow[kind].get(key)
            if old is not None and old == obj:
                return obj
            obj.meta.resource_version = self._advance_rv()
            self._objects[kind][key] = obj
            dg = self._digest
            if dg is not None:
                dg.set_obj(kind, key, obj)
            self._notify(Event(kind, EventType.UPDATED, obj, old))
            return obj

    def update_cas(self, kind: str, obj: Any, expected_rv: int) -> Any:
        """Compare-and-swap update: succeeds only while the stored object's
        resource version still equals ``expected_rv``; raises Conflict
        otherwise (two candidates racing for one lease cannot both win)."""
        with self._mu:
            self._materialize(kind, obj.meta.key)
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
            self._materialize(kind, key)
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
            dg = self._digest
            trips = [] if dg is not None else None
            for k, v in fields.items():
                parent, leaf = _walk(obj, k)
                if trips is not None:
                    # the value before setattr: the digest delta's old leaf
                    trips.append((k, getattr(parent, leaf), v))
                setattr(parent, leaf, v)
            if trips is not None:
                dg.apply_fields(kind, key, trips, obj=obj)
            obj.meta.resource_version = self._advance_rv()
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
            ev = Event(kind, EventType.UPDATED, obj, shadow, fields=fields)
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

    def _stage_lazy_rows(self, keys: List[str], field: str, values: Optional[List[Any]]):
        """Stage one segment section's scalar patches in the lazy overlay:
        per row the existence and pending-aware no-op checks, a contiguous
        rv block for the rows that change, a last-wins merge into a pending
        entry.  ``values`` is the per-row column, or None for the constant
        True (eviction rows).  Returns ``(sparse errs, changed rows, Event
        rows, rv0)``.  Must run under ``_mu``."""
        pods = self._objects["Pod"]
        pend = self._lazy_patch["Pod"]
        errs: List[List[Any]] = []
        changed: List[int] = []
        old_vals: List[Any] = []  # the pending-aware values before, beside changed
        ev_rows: List[int] = []
        for i, key in enumerate(keys):
            obj = pods.get(key)
            if obj is None:
                errs.append([i, "NotFound: " + repr(f"Pod {key} not found")])
                continue
            p = pend.get(key)
            cur = p[0].get(field, _MISSING) if p else _MISSING
            if cur is _MISSING:
                cur = getattr(obj, field)
            ev_rows.append(i)
            if cur == (True if values is None else values[i]):
                continue  # a no-op write: its Event only, no patch row
            changed.append(i)
            old_vals.append(cur)
        rv0 = self._advance_rv(len(changed)) - len(changed) + 1
        dg = self._digest
        for j, i in enumerate(changed):
            key = keys[i]
            value = True if values is None else values[i]
            if dg is not None:
                # a staged row digests now (one scalar-leaf delta): the
                # materialization later folds exactly this value, so it is
                # digest-neutral
                dg.apply_fields("Pod", key, ((field, old_vals[j], value),))
            p = pend.get(key)
            if p is None:
                pend[key] = ({field: value}, rv0 + j)
            else:
                f = dict(p[0])
                f[field] = value
                pend[key] = (f, rv0 + j)
        return errs, changed, ev_rows, rv0

    def apply_segment_lazy(self, seg, stamp: Optional[float] = None) -> Dict[str, Any]:
        """The server half of the columnar wire: acknowledge a whole
        decision segment under one lock hold without touching a live
        object.  Bind and eviction rows stage in the lazy-patch overlay
        (resource versions assigned now, fields folded in on the first
        read); Event rows stage as ``EventLogBlock`` references that become
        ClusterEvent objects only when an Event read asks.  No watcher
        event fans out: the StoreServer appends the blocks to its own log.
        Returns the sparse per-row errors and the blocks the server logs:

          bind_block:   (keys, hostnames, rv0) of the rows that changed
          evict_block:  (keys, rv0)
          event_blocks: (bind EventLogBlock, evict EventLogBlock)

        A row whose write is a no-op (already on that node, already
        deleting) gets its Event but no patch row, as on the per-object
        path.  ``stamp`` pins the Events' creation time (WAL replay passes
        the original one); None is now.  A resubmitted segment (same uid
        block) stages no Event row a second time."""
        from volcano_tpu_torch.store import segment as segmod

        with self._mu:
            t0 = time.perf_counter()
            if stamp is None:
                stamp = time.time()
            resubmit = self._note_segment(seg)
            hosts = seg.bind_hosts
            errs_b, changed_b, ev_b, rv_b0 = self._stage_lazy_rows(
                seg.bind_keys, "node_name", hosts)
            t1 = time.perf_counter()
            errs_e, changed_e, ev_e, rv_e0 = self._stage_lazy_rows(
                seg.evict_keys, "deleting", None)
            t2 = time.perf_counter()
            n_b = len(seg.bind_keys)
            if resubmit:
                # drop the Event rows the first submission staged or
                # materialized already (slot -> key through the uid block)
                lc0 = self._lazy_create.get("Event") or {}
                events = self._objects["Event"]

                def _fresh(slot: int) -> bool:
                    k = f"/{segmod.event_name(seg.ev_token, slot)}"
                    return k not in lc0 and k not in events

                ev_b = [i for i in ev_b if _fresh(seg.ev_start + i)]
                ev_e = [j for j in ev_e if _fresh(seg.ev_start + n_b + j)]
            # the Event rows' rv block follows every patch, the per-object
            # path's order
            n_ev = len(ev_b) + len(ev_e)
            rv_ev0 = self._advance_rv(n_ev) - n_ev + 1
            ebind = segmod.EventLogBlock(
                segmod.BIND_REASON, seg.ev_token,
                [seg.ev_start + i for i in ev_b],
                [seg.bind_keys[i] for i in ev_b],
                [hosts[i] for i in ev_b],
                rv_ev0, stamp)
            reasons = seg.evict_reason_strs
            eevict = segmod.EventLogBlock(
                segmod.EVICT_REASON, seg.ev_token,
                [seg.ev_start + n_b + j for j in ev_e],
                [seg.evict_keys[j] for j in ev_e],
                [reasons[j] for j in ev_e],
                rv_ev0 + len(ev_b), stamp)
            lc = self._lazy_create["Event"]
            for blk in (ebind, eevict):
                for r in range(len(blk)):
                    lc[blk.key(r)] = (blk, r)
            t3 = time.perf_counter()
            return {
                "binds": errs_b, "evicts": errs_e,
                "bind_block": ([seg.bind_keys[i] for i in changed_b],
                               [hosts[i] for i in changed_b], rv_b0),
                "evict_block": ([seg.evict_keys[j] for j in changed_e], rv_e0),
                "event_blocks": (ebind, eevict),
                "timings": {"binds_s": t1 - t0, "evicts_s": t2 - t1,
                            "events_s": t3 - t2},
            }

    def delete(self, kind: str, key: str) -> Optional[Any]:
        with self._mu:
            self._materialize(kind, key)
            obj = self._objects[kind].pop(key, None)
            if obj is not None:
                dg = self._digest
                if dg is not None:
                    dg.remove(kind, key)
                self._notify(Event(kind, EventType.DELETED, obj))
            return obj

    def get(self, kind: str, key: str) -> Optional[Any]:
        lp = self._lazy_patch.get(kind)
        lc = self._lazy_create.get(kind)
        if (lp and key in lp) or (lc and key in lc):
            with self._mu:
                self._materialize(kind, key)
        return self._objects[kind].get(key)

    def list(self, kind: str) -> List[Any]:
        with self._mu:
            # lazily created objects (segment Events) materialize only here
            self._materialize_kind(kind)
            return list(self._objects[kind].values())

    def items(self, kind: str) -> Iterator[Any]:
        return iter(self.list(kind))

    # -- the state digest (vtaudit.py) --------------------------------------------

    def digest_payload(self, nshards: int = 1) -> Optional[Dict[str, Any]]:
        """The kept digest's rollup (root, shards, kinds; hex): the store
        half of ``/healthz``, ``/debug/digest`` and the beacons.  None when
        the audit is disarmed."""
        with self._mu:
            dg = self._digest
            return None if dg is None else dg.payload(nshards)

    def digest_buckets(self, shard: Optional[int] = None, nshards: int = 1) -> Dict[str, str]:
        """The kept per-(kind, namespace) bucket digests."""
        with self._mu:
            dg = self._digest
            return {} if dg is None else dg.bucket_payload(shard, nshards)

    def digest_objects(self, kind: str, namespace: str) -> Dict[str, str]:
        """The kept per-object digests of one bucket."""
        with self._mu:
            dg = self._digest
            return {} if dg is None else dg.object_payload(kind, namespace)

    def recompute_digest(self):
        """The ground truth: a fresh digest of every (materialized) object,
        independent of the kept table.  A write that bypassed the verbs
        shows as the difference between the two."""
        from volcano_tpu_torch import vtaudit

        with self._mu:
            self.materialize_all()
            return vtaudit.table_from_objects(
                (kind, obj) for kind, bucket in self._objects.items()
                for obj in bucket.values())

    def watch(self, kind: str) -> Deque[Event]:
        """Subscribe to a kind; returns the event queue to drain."""
        q: Deque[Event] = deque()
        self._watchers[kind].append(q)
        return q

    def pending_events(self) -> bool:
        return any(q for qs in self._watchers.values() for q in qs)

"""vtaudit: the incremental state digest of the store bus.

The port's copy of ``volcano_tpu/vtaudit.py``.  An incremental,
order-independent digest of the whole object state, cheap enough to keep
on every mutation, comparable across processes, and localizable to the
exact object on a mismatch.  The contract is the JAX package's, hex for
hex: for the same objects the port's per-object, bucket, kind, shard and
root digests equal the JAX package's, because both are a function of the
canonical encoded form (``codec.encode``), and equal objects encode to
equal values in both packages.

* Per object: ``D(kind, key, enc) = (M(kind, key) * sum(leaf_hash(path,
  value))) mod 2^64`` over the flattened encoded form, where ``M`` is a
  per-identity odd multiplier and ``leaf_hash`` mixes ``crc32(path +
  typed scalar repr)`` through a splitmix64 finalizer.  A patch that
  changes k leaves updates the digest with k hash lookups and one
  multiply.
* Per ``(kind, namespace)`` bucket: the sum of its objects' digests mod
  2^64, so two replicas holding the same set of objects agree whatever
  the order their writes applied in.
* Rollups: namespace -> shard through ``partition.shard_of``, shards ->
  root by the same modular sum.
* ``meta.resource_version`` is left out (``SKIP_LEAVES``): WAL replay and
  recovery restamp it.  ``Event`` objects are left out
  (``AUDITED_KINDS``): shadowless, never mirrored, the hottest create.

Consumers: ``store/store.py`` keeps the authoritative table under ``_mu``;
``store/server.py`` serves it (``/healthz``, ``/debug/digest``) and stamps
digest beacons into the watch stream; ``scheduler/fastpath/mirror.py``
keeps an independent table from its watch stream and verifies it against
the beacons (remote) or the store's table (in-process).  The offline walk
``vtctl audit`` comes with the tooling (ROADMAP item 13).
"""

from __future__ import annotations

import enum
import os
import zlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.store import codec
from volcano_tpu_torch.store.partition import shard_of

_MASK = (1 << 64) - 1

#: leaves left out of every digest: bookkeeping that WAL replay and
#: recovery restamp
SKIP_LEAVES = frozenset({"meta.resource_version"})

#: the kinds the digest covers: the codec registry but the Event stream
AUDITED_KINDS = frozenset(k for k in codec.KIND_CLASSES if k != "Event")

#: the wire kind of a digest beacon in the server's event log: never an
#: object kind, delivered to every watcher whatever its filters
BEACON_KIND = "__beacon__"

#: markers for empty containers (a leaf must exist, or {} and absent would
#: hash alike); the control prefix keeps them out of real string space
_EMPTY_DICT = "\x01{}"
_EMPTY_LIST = "\x01[]"

_CACHE_CAP = 1 << 20


def enabled() -> bool:
    """Digest upkeep is on by default; ``VOLCANO_TPU_AUDIT=0`` (or off,
    false, no) disarms it.  Read at each construction site, never cached."""
    return os.environ.get("VOLCANO_TPU_AUDIT", "1").lower() not in (
        "0", "off", "false", "no")


# -- hash primitives ----------------------------------------------------------


def _mix64(x: int) -> int:
    """splitmix64's finalizer: spreads crc32's 32 bits over all 64."""
    x &= _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


#: (path, scalar) -> leaf hash.  Paths and values repeat massively (every
#: pod shares its field paths; node names and phases recur), so the hot
#: cost is one dict hit.  The key is the JAX package's: 1, 1.0 and True
#: share an entry, as there
_leaf_cache: Dict[Tuple[str, Any], int] = {}
#: (kind, key) -> odd multiplier
_mult_cache: Dict[Tuple[str, str], int] = {}


def leaf_hash(path: str, value: Any) -> int:
    """The hash of one flattened scalar leaf.  The value's repr is tagged
    by type, so that 1, 1.0, "1" and True stay distinct through JSON."""
    ck = (path, value)
    try:
        h = _leaf_cache.get(ck)
    except TypeError:  # an unhashable scalar cannot occur in encoded forms
        h = None
        ck = None
    if h is None:
        if value is None:
            tag = "z"
        elif value is True:
            tag = "b1"
        elif value is False:
            tag = "b0"
        elif isinstance(value, str):
            tag = "s" + value
        else:
            tag = "n" + repr(value)
        h = _mix64(zlib.crc32(f"{path}\x00{tag}".encode()))
        if ck is not None and len(_leaf_cache) < _CACHE_CAP:
            _leaf_cache[ck] = h
    return h


def key_mult(kind: str, key: str) -> int:
    """The per-identity odd multiplier: it binds a leaf sum to the object
    it describes, so two objects of equal content still differ."""
    m = _mult_cache.get((kind, key))
    if m is None:
        m = _mix64(zlib.crc32(f"{kind}\x00{key}".encode()) + 0x9E3779B97F4A7C15) | 1
        if len(_mult_cache) < _CACHE_CAP:
            _mult_cache[(kind, key)] = m
    return m


def _flatten(enc: Any, path: str, out: List[Tuple[str, Any]]) -> None:
    if isinstance(enc, dict):
        if not enc:
            out.append((path, _EMPTY_DICT))
            return
        for k in sorted(enc):
            _flatten(enc[k], f"{path}.{k}" if path else str(k), out)
    elif isinstance(enc, (list, tuple)):
        if not enc:
            out.append((path, _EMPTY_LIST))
            return
        for i, v in enumerate(enc):
            _flatten(v, f"{path}.{i}", out)
    elif path not in SKIP_LEAVES:
        out.append((path, enc))


def leaf_sum(enc: Any, path: str = "") -> int:
    """The sum of the leaf hashes of one encoded subtree rooted at
    ``path``: the building block of absolute digests and of patch deltas
    (a scalar at ``path`` contributes exactly its leaf in the absolute
    flatten)."""
    out: List[Tuple[str, Any]] = []
    _flatten(enc, path, out)
    s = 0
    for p, v in out:
        s += leaf_hash(p, v)
    return s & _MASK


#: (class, path prefix) -> its fields' (name, dotted path, skipped) rows,
#: in the sorted order the encoded dict flattens in; the path strings are
#: shared, so their hashes are computed once
_plans: Dict[Tuple[type, str], Tuple[Tuple[str, str, bool], ...]] = {}
#: list path -> its elements' paths
_item_paths: Dict[str, List[str]] = {}


def _child(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _plan(cls: type, path: str, names) -> Tuple[Tuple[str, str, bool], ...]:
    plan = _plans.get((cls, path))
    if plan is None:
        plan = tuple((n, p, p in SKIP_LEAVES)
                     for n, p in ((n, _child(path, n)) for n in sorted(names)))
        _plans[(cls, path)] = plan
    return plan


#: path -> {a Resource's wire key -> its path under it}
_resource_paths: Dict[str, Dict[str, str]] = {}


def _value_sum(v: Any, path: str) -> int:
    """``leaf_sum(codec.encode(v), path)`` without building the encoded
    form: one walk of the decoded value with the encoder's rules
    (dataclasses by ``codec``'s field order, enums by value, ``Resource``
    by ``codec.resource_fields``, dict keys as strings), the flatten's
    (sorted keys, list indices, the empty-container markers,
    ``SKIP_LEAVES``) and the leaf cache.  A value
    the walk does not know goes through the encoder.  The sum is not
    reduced mod 2^64; the callers reduce it."""
    cls = v.__class__
    if v is None or cls in _SCALAR_TYPES:
        if path in SKIP_LEAVES:
            return 0
        h = _leaf_cache.get((path, v))
        return h if h is not None else leaf_hash(path, v)
    names = codec._fields_cache.get(cls)
    if names is not None:
        if not names:
            return leaf_hash(path, _EMPTY_DICT)
        s = 0
        cache_get = _leaf_cache.get
        for name, sub, skip in _plan(cls, path, names):
            x = getattr(v, name)
            if x is None or x.__class__ in _SCALAR_TYPES:
                # a scalar field, inline: most of an object's leaves
                if not skip:
                    h = cache_get((sub, x))
                    s += h if h is not None else leaf_hash(sub, x)
            else:
                s += _value_sum(x, sub)
        return s
    if isinstance(v, enum.Enum):
        return _value_sum(v.value, path)
    if cls is Resource:
        paths = _resource_paths.get(path)
        if paths is None:
            paths = _resource_paths[path] = {}
        s = 0
        for key, x in codec.resource_fields(v):
            sub = paths.get(key)
            if sub is None:
                sub = paths[key] = _child(path, key)
            s += _value_sum(x, sub)
        return s
    if cls is list or cls is tuple:
        if not v:
            return leaf_hash(path, _EMPTY_LIST)
        paths = _item_paths.get(path)
        if paths is None:
            paths = _item_paths[path] = []
        while len(paths) < len(v):
            paths.append(f"{path}.{len(paths)}")
        s = 0
        for x, sub in zip(v, paths):
            s += _value_sum(x, sub)
        return s
    if cls is dict:
        if not v:
            return leaf_hash(path, _EMPTY_DICT)
        d = {str(k): x for k, x in v.items()}
        s = 0
        for k in sorted(d):
            s += _value_sum(d[k], _child(path, k))
        return s
    return leaf_sum(codec.encode(v), path)


#: the scalar classes a value's leaf is itself (an enum or a subclass takes
#: the encoder's route)
_SCALAR_TYPES = frozenset({bool, int, float, str})


def value_leaf_sum(value: Any, path: str = "") -> int:
    """``leaf_sum(codec.encode(value), path)``, walked on the decoded
    value (``_value_sum``)."""
    return _value_sum(value, path) & _MASK


def obj_digest_enc(kind: str, key: str, enc: Any) -> int:
    """The per-object digest of a canonical encoded form."""
    return (key_mult(kind, key) * leaf_sum(enc)) & _MASK


def obj_digest(kind: str, obj: Any) -> int:
    """The per-object digest of a decoded object: ``obj_digest_enc`` of
    its encoding, walked on the object itself."""
    return (key_mult(kind, obj.meta.key) * value_leaf_sum(obj)) & _MASK


def field_delta(path: str, old_value: Any, new_value: Any) -> int:
    """The leaf-sum delta of one field going ``old_value -> new_value``
    (decoded values, as their encodings flatten).  Times ``key_mult`` it is
    the digest delta."""
    return (_value_sum(new_value, path) - _value_sum(old_value, path)) & _MASK


def ns_of_key(key: str) -> str:
    return key.partition("/")[0]


def hexd(d: int) -> str:
    return "%016x" % (d & _MASK)


# -- the digest table ---------------------------------------------------------


class DigestTable:
    """The incremental digest state: per-object digests and per-``(kind,
    namespace)`` bucket sums.  Every mutator is O(changed leaves); the
    caller locks (the Store under ``_mu``, the mirror on its own thread).
    Plain dicts throughout, so it pickles with the store."""

    def __init__(self) -> None:
        #: (kind, namespace) -> the modular sum of its object digests
        self.buckets: Dict[Tuple[str, str], int] = {}
        #: kind -> {key -> object digest}
        self.objd: Dict[str, Dict[str, int]] = {}

    # -- mutators (the caller holds the apply lock) ---------------------------

    def set_obj(self, kind: str, key: str, obj: Any) -> None:
        """The absolute (re)digest of one object: create and update."""
        if kind not in AUDITED_KINDS:
            return
        self._set(kind, key, (key_mult(kind, key) * value_leaf_sum(obj)) & _MASK)

    def set_enc(self, kind: str, key: str, enc: Any) -> None:
        if kind not in AUDITED_KINDS:
            return
        self._set(kind, key, obj_digest_enc(kind, key, enc))

    def _set(self, kind: str, key: str, d: int) -> None:
        per = self.objd.setdefault(kind, {})
        old = per.get(key, 0)
        per[key] = d
        b = (kind, ns_of_key(key))
        self.buckets[b] = (self.buckets.get(b, 0) + d - old) & _MASK

    def apply_fields(self, kind: str, key: str, trips: Iterable[Tuple[str, Any, Any]],
                     obj: Any = None) -> None:
        """The delta path: ``trips`` holds ``(dotted path, old value, new
        value)`` per changed field (the copy-on-write patch and the lazy
        staging).  An object never digested gets an absolute set from
        ``obj`` (defensive: the verbs always digest first)."""
        if kind not in AUDITED_KINDS:
            return
        per = self.objd.setdefault(kind, {})
        old = per.get(key)
        if old is None:
            if obj is not None:
                self.set_obj(kind, key, obj)
            return
        delta = 0
        for path, ov, nv in trips:
            delta += field_delta(path, ov, nv)
        delta = (key_mult(kind, key) * (delta & _MASK)) & _MASK
        per[key] = (old + delta) & _MASK
        b = (kind, ns_of_key(key))
        self.buckets[b] = (self.buckets.get(b, 0) + delta) & _MASK

    def remove(self, kind: str, key: str) -> None:
        if kind not in AUDITED_KINDS:
            return
        per = self.objd.get(kind)
        d = per.pop(key, None) if per else None
        if d is not None:
            b = (kind, ns_of_key(key))
            self.buckets[b] = (self.buckets.get(b, 0) - d) & _MASK

    def clear(self) -> None:
        self.buckets.clear()
        self.objd.clear()

    # -- rollups ----------------------------------------------------------------

    def shard_rollup(self, nshards: int) -> List[int]:
        out = [0] * max(1, int(nshards))
        for (_, ns), d in self.buckets.items():
            s = shard_of(ns, len(out))
            out[s] = (out[s] + d) & _MASK
        return out

    def kind_rollup(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for (kind, _), d in self.buckets.items():
            out[kind] = (out.get(kind, 0) + d) & _MASK
        # zero sums drop out: a kind deleted whole equals one never seen
        return {k: d for k, d in out.items() if d}

    def root(self) -> int:
        s = 0
        for d in self.buckets.values():
            s += d
        return s & _MASK

    def payload(self, nshards: int = 1) -> Dict[str, Any]:
        """The shape every surface speaks, hex so that the values survive
        JSON."""
        return {
            "root": hexd(self.root()),
            "shards": [hexd(d) for d in self.shard_rollup(nshards)],
            "kinds": {k: hexd(d) for k, d in sorted(self.kind_rollup().items())},
        }

    def bucket_payload(self, shard: Optional[int] = None, nshards: int = 1) -> Dict[str, str]:
        """Per-``(kind, namespace)`` buckets (``"kind|ns"`` keys), of one
        shard when ``shard`` is given: the localization walk's middle
        tier."""
        out: Dict[str, str] = {}
        for (kind, ns), d in self.buckets.items():
            if not d:
                continue  # an emptied bucket equals one never seen
            if shard is not None and shard_of(ns, nshards) != shard:
                continue
            out[f"{kind}|{ns}"] = hexd(d)
        return out

    def object_payload(self, kind: str, namespace: str) -> Dict[str, str]:
        """The per-object digests of one bucket: the walk's bottom tier."""
        per = self.objd.get(kind) or {}
        return {k: hexd(d) for k, d in per.items() if ns_of_key(k) == namespace}


def table_from_objects(items: Iterable[Tuple[str, Any]]) -> DigestTable:
    """A full recompute from ``(kind, obj)`` pairs: the rebuild of a store
    unpickled without a table, the mirror's list seed, and the ground truth
    of ``/debug/digest?recompute=1``."""
    t = DigestTable()
    for kind, obj in items:
        if kind in AUDITED_KINDS:
            t.set_obj(kind, obj.meta.key, obj)
    return t


def merge_digest_payloads(payloads: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Roll N ``payload()`` dicts, each of a one-shard server owning a
    disjoint namespace slice, into the payload one server holding the
    union reports: every rollup is a modular sum of disjoint bucket sums,
    so the root is the sum of the roots, the kinds add the same way, and
    the shard list is the roots in order.  (Its JAX caller is the process
    mesh's router, ROADMAP item 11b part 4.)"""
    root = 0
    shard_roots: List[str] = []
    kinds: Dict[str, int] = {}
    for p in payloads:
        r = int(str(p.get("root", "0")), 16)
        root = (root + r) & _MASK
        shard_roots.append(hexd(r))
        for k, v in (p.get("kinds") or {}).items():
            kinds[k] = (kinds.get(k, 0) + int(str(v), 16)) & _MASK
    return {"root": hexd(root), "shards": shard_roots,
            "kinds": {k: hexd(d) for k, d in sorted(kinds.items())}}


# -- comparison and localization ----------------------------------------------


def diff_maps(a: Dict[str, str], b: Dict[str, str]) -> List[str]:
    """The keys whose hex digests differ (absent reads as zero on either
    side)."""
    zero = hexd(0)
    return sorted(k for k in set(a) | set(b) if a.get(k, zero) != b.get(k, zero))


def diff_kinds(a: Dict[str, str], b: Dict[str, str], kinds: Iterable[str]) -> List[str]:
    """The per-kind comparison restricted to ``kinds``: a replica that
    watches a subset (the mirror) compares only what both hold."""
    zero = hexd(0)
    return sorted(k for k in kinds if a.get(k, zero) != b.get(k, zero))


# -- beacons ------------------------------------------------------------------


def beacon_interval_s() -> float:
    """Seconds between beacons on a moving event log
    (``VOLCANO_TPU_AUDIT_BEACON_S``, 1.0; tests pin it low)."""
    try:
        return float(os.environ.get("VOLCANO_TPU_AUDIT_BEACON_S", "1.0"))
    except ValueError:
        return 1.0


def beacon_entry(seq: int, payload: Dict[str, Any], ts: float) -> Dict[str, Any]:
    """One seq-pinned checkpoint record of the server's event log: ``kind``
    is the sentinel every watch filter passes, and the digest describes the
    state exactly at ``seq`` (appended at the tail of its pump, under the
    server lock)."""
    return {"seq": seq, "kind": BEACON_KIND, "type": "Beacon",
            "digest": dict(payload, seq=seq, ts=round(ts, 6))}


# -- the /debug/digest source of the metrics server ---------------------------

#: the process's digest source: a callable returning the /debug/digest body
#: (the scheduler's mirror registers its view)
_DEBUG_SOURCE = None


def set_debug_source(fn) -> None:
    global _DEBUG_SOURCE
    _DEBUG_SOURCE = fn


def has_debug_source() -> bool:
    return _DEBUG_SOURCE is not None


def debug_payload() -> Dict[str, Any]:
    src = _DEBUG_SOURCE
    if src is None:
        return {"enabled": enabled(), "digest": None}
    try:
        return src()
    except Exception as e:  # noqa: BLE001 — a debug surface never raises out
        return {"enabled": enabled(), "error": repr(e)}


# -- the WAL replay audit -----------------------------------------------------


def replay_wal_digest(state_path: str, shards: int = 0) -> Dict[str, Any]:
    """Replay a state file and its WAL lineage into a digest without
    touching the files: recovery rotates segments and reaps covered ones,
    so the lineage is copied into a scratch directory and the port's own
    ``StoreServer`` recovers there (constructed, never started).  Returns
    the recovered payload and the replay's counts."""
    import shutil
    import tempfile

    from volcano_tpu_torch.store.partition import leftover_shard_dirs
    from volcano_tpu_torch.store.server import StoreServer

    wal_dir = state_path + ".wal"
    tmp = tempfile.mkdtemp(prefix="vtaudit-wal-")
    try:
        scratch_state = os.path.join(tmp, os.path.basename(state_path))
        if os.path.exists(state_path):
            shutil.copy2(state_path, scratch_state)
        if os.path.isdir(wal_dir):
            shutil.copytree(wal_dir, scratch_state + ".wal")
        if shards <= 0:
            shards = max(1, len(leftover_shard_dirs(scratch_state + ".wal")))
        srv = StoreServer(port=0, state_path=scratch_state, wal=True, shards=shards)
        try:
            with srv.store._mu:
                dg = srv.store._digest
                payload = dg.payload(shards) if dg is not None else None
            stats = srv.wal.stats() if srv.wal is not None else {}
            return {"digest": payload, "seq": srv.seq, "shards": shards,
                    "replayed_records": stats.get("replayed_records", 0),
                    "torn_tails": stats.get("torn_tails", 0)}
        finally:
            srv._saver_stop.set()
            if srv._saver is not None:
                srv._saver.join(timeout=5)
            if srv.wal is not None:
                srv.wal.sync_close()
            srv.httpd.server_close()  # the never-served socket
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

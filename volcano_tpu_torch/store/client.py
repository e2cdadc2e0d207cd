"""RemoteStore: a Store-compatible client of the HTTP store server.

The port's copy of ``volcano_tpu/store/client.py`` for an unreplicated
server, partitioned or not.  The scheduler takes a Store and uses its verbs (create, update,
update_cas, patch, bulk, apply_segment, delete, get, list, items, watch),
so pointing it at a RemoteStore moves it into its own OS process with no
other change.  Watch queues buffer locally and refill from the server's
ordered event log on demand (``popleft`` and truthiness poll without
blocking), the deterministic drain-when-pumped model of the in-process
Store.  A client that fell off the server's log buffer gets StaleWatch and
relists, the reference's "resourceVersion too old" recovery.

An idempotent GET is re-issued once after a connection cut; a mutation is
never re-issued blindly (a cut request may have committed), except a
decision segment, which the applier re-ships once because the server
dedupes it on its reserved uid block.  Against a partitioned server
(``/healthz`` ``shards`` > 1, read once into ``segment_shards``) the applier
ships one sub-segment a shard, ``apply_segment(sub, shard=s)``; a
``RemoteStore(url, shard=i)`` watches shard i's slice of the log.  The
digest beacons wait for ROADMAP item 11b part 2, the replica-set verbs
(``resolve_leader``, the NotLeader redirect) for part 3, the process mesh's
shard map for part 4.
"""

from __future__ import annotations

import http.client
import json
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Any, Dict, List, Optional
from urllib.parse import quote

from volcano_tpu_torch import trace
from volcano_tpu_torch.store.codec import decode_object, encode, encode_fields
from volcano_tpu_torch.store.store import Conflict, Event, EventType, PreconditionFailed


class StaleWatch(RuntimeError):
    """The server dropped events this client never saw; relist required."""


class RemoteStoreError(RuntimeError):
    pass


class AdmissionError(RemoteStoreError):
    """The server refused a write as inadmissible (422): a kind this server
    does not have, or a Job its admission rejects."""


class _RemoteWatchQueue:
    """deque façade over the client's event buffer for one kind."""

    def __init__(self, client: "RemoteStore", kind: str):
        self._client = client
        self._kind = kind
        self._buf: deque = deque()

    def popleft(self) -> Event:
        if not self._buf:
            self._client.poll()
        return self._buf.popleft()  # IndexError when empty, like deque

    def __len__(self) -> int:
        if not self._buf:
            self._client.poll()
        return len(self._buf)

    def __bool__(self) -> bool:
        return len(self) > 0

    def append(self, ev: Event) -> None:
        self._buf.append(ev)


class _WireEvent(Event):
    """A watch-stream Event whose ``old`` object decodes on its first read:
    the fast cycle's mirror reads only ``obj``, and a drain after a cycle's
    write-back carries an old encoding for every bound pod."""

    def __init__(self, kind, type_, obj, old_enc, enc):
        self._old_enc = old_enc
        super().__init__(kind, type_, obj, enc=enc)

    @property
    def old(self):
        if self._old_enc is not None:
            self._old = decode_object(self.kind, self._old_enc)
            self._old_enc = None
        return self._old

    @old.setter
    def old(self, value):
        self._old = value


def _connection_cut(e: BaseException) -> bool:
    """A connection-level transient: the request never reached the server
    (refused or reset on connect) or the reply was cut mid-body; re-issuing
    an idempotent GET is safe after it."""
    if isinstance(e, urllib.error.URLError) and not isinstance(e, urllib.error.HTTPError):
        reason = e.reason
        if isinstance(reason, BaseException):
            e = reason
    return isinstance(e, (
        ConnectionResetError, ConnectionRefusedError, BrokenPipeError,
        http.client.RemoteDisconnected, http.client.IncompleteRead,
        http.client.BadStatusLine,
    ))


class RemoteStore:
    def __init__(self, url: str, timeout: float = 30.0, shard: Optional[int] = None):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self._watches: Dict[str, List[_RemoteWatchQueue]] = {}
        self._cursor = 0
        #: a shard-scoped watcher (partitioned servers) polls only that
        #: shard's slice of the log
        self.shard = shard
        #: the server's decision-bus shard count from /healthz, read once
        #: (1: unpartitioned); a reconnect clears it
        self._segment_shards: Optional[int] = None

    # -- http ------------------------------------------------------------------

    def _request(self, method: str, path: str, payload: Optional[dict] = None):
        data = json.dumps(payload).encode() if payload is not None else None
        headers = {"Content-Type": "application/json"} if data else {}
        if trace.TRACER is not None:
            # the active span's context rides the request, so the server's
            # request span continues this trace
            tid, sid = trace.current()
            if tid:
                headers[trace.HEADER] = trace.format_header(tid, sid)
        # a GET (get, list, a watch poll) is re-issued once after a
        # connection cut; a mutation never is here (it may have committed)
        attempts = 2 if method == "GET" else 1
        for attempt in range(attempts):
            try:
                req = urllib.request.Request(self.url + path, data=data, method=method,
                                             headers=headers)
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    return resp.status, json.loads(resp.read() or b"{}")
            except urllib.error.HTTPError as e:
                try:
                    body = json.loads(e.read() or b"{}")
                except Exception:  # noqa: BLE001
                    body = {"error": str(e)}
                return e.code, body
            except (OSError, http.client.HTTPException) as e:
                if _connection_cut(e):
                    # the server may come back partitioned otherwise
                    self._segment_shards = None
                    if attempt + 1 < attempts:
                        continue
                raise

    @staticmethod
    def _err(code: int, body: dict) -> str:
        return body.get("error", f"http {code}")

    # -- CRUD (the Store interface) ------------------------------------------------

    def create(self, kind: str, obj: Any) -> Any:
        code, body = self._request("POST", f"/apis/{kind}", {"object": encode(obj)})
        if code == 422:
            raise AdmissionError(self._err(code, body))
        if code == 409:
            raise KeyError(self._err(code, body))
        if code != 201:
            raise RemoteStoreError(self._err(code, body))
        new = decode_object(kind, body["object"])
        # the server-stamped fields go back into the caller's object, which
        # stays live (Store.create stamps in place the same way)
        obj.meta.resource_version = new.meta.resource_version
        obj.meta.creation_timestamp = new.meta.creation_timestamp
        obj.meta.uid = new.meta.uid
        return obj

    def update(self, kind: str, obj: Any, cas: Optional[int] = None) -> Any:
        path = f"/apis/{kind}" + (f"?cas={cas}" if cas is not None else "")
        code, body = self._request("PUT", path, {"object": encode(obj)})
        if code == 422:
            raise AdmissionError(self._err(code, body))
        if code == 404:
            raise KeyError(self._err(code, body))
        if code == 409 and body.get("conflict"):
            raise Conflict(self._err(code, body))
        if code != 200:
            raise RemoteStoreError(self._err(code, body))
        new = decode_object(kind, body["object"])
        obj.meta.resource_version = new.meta.resource_version
        return obj

    def update_cas(self, kind: str, obj: Any, expected_rv: int) -> Any:
        """Compare-and-swap update (``Store.update_cas`` over the wire)."""
        return self.update(kind, obj, cas=expected_rv)

    def patch(self, kind: str, key: str, fields: Dict[str, Any],
              when: Optional[Dict[str, Any]] = None) -> Any:
        payload = {"fields": encode_fields(fields)}
        if when:
            payload["when"] = encode_fields(when)
        code, body = self._request("PATCH", f"/apis/{kind}/obj?key={quote(key, safe='')}",
                                   payload)
        if code == 404:
            raise KeyError(self._err(code, body))
        if code == 409:
            raise PreconditionFailed(self._err(code, body))
        if code == 422:
            raise AdmissionError(self._err(code, body))
        if code != 200:
            raise RemoteStoreError(self._err(code, body))
        return decode_object(kind, body["object"])

    #: the shortest run of same-shape patches worth a columnar op
    _COL_MIN_RUN = 16
    _COL_SCALARS = (str, int, float, bool, type(None))

    @classmethod
    def _compress_patch_runs(cls, wire: List[dict]) -> List[dict]:
        """Collapse runs of same-shape scalar-valued patch ops into ONE
        columnar ``patch_col`` op: the keys, a value column per field (or a
        constant where the column is all equal).  The bulk enqueue shipping
        (thousands of identical conditional phase flips) shrinks to a keys
        array and a constant.  Object-valued patches (whole statuses) stay
        per op, so that the server never shares one decoded object across
        rows."""
        out: List[dict] = []
        i, n = 0, len(wire)
        while i < n:
            w = wire[i]
            fields = w.get("fields")
            if w["op"] != "patch" or not fields or not all(
                    isinstance(v, cls._COL_SCALARS) for v in fields.values()):
                out.append(w)
                i += 1
                continue
            names = tuple(sorted(fields))
            when = w.get("when")
            run = [w]
            j = i + 1
            while j < n:
                x = wire[j]
                xf = x.get("fields")
                if (x["op"] != "patch" or x["kind"] != w["kind"]
                        or not xf or tuple(sorted(xf)) != names
                        or x.get("when") != when
                        or not all(isinstance(v, cls._COL_SCALARS) for v in xf.values())):
                    break
                run.append(x)
                j += 1
            if len(run) >= cls._COL_MIN_RUN:
                cols: Dict[str, list] = {}
                const: Dict[str, Any] = {}
                for f in names:
                    vals = [x["fields"][f] for x in run]
                    if all(v == vals[0] for v in vals):
                        const[f] = vals[0]
                    else:
                        cols[f] = vals
                cop: Dict[str, Any] = {"op": "patch_col", "kind": w["kind"],
                                       "keys": [x["key"] for x in run]}
                if cols:
                    cop["columns"] = cols
                if const:
                    cop["const"] = const
                if when is not None:
                    cop["when"] = when
                out.append(cop)
            else:
                out.extend(run)
            i = j
        return out

    def bulk(self, ops: List[Dict[str, Any]]) -> List[Optional[str]]:
        """``Store.bulk`` over the wire: ONE round trip for N mutations.
        Ops carry live objects, encoded here; homogeneous patch runs ship
        columnar (``_compress_patch_runs``).  One error string (or None) an
        op, as ``Store.bulk``."""
        wire = []
        for op in ops:
            w = {"op": op["op"], "kind": op["kind"]}
            if "object" in op:
                w["object"] = encode(op["object"])
            if "key" in op:
                w["key"] = op["key"]
            if "fields" in op:
                w["fields"] = encode_fields(op["fields"])
            if "when" in op:
                w["when"] = encode_fields(op["when"])
            if "cas" in op:
                w["cas"] = op["cas"]
            wire.append(w)
        wire = self._compress_patch_runs(wire)
        code, body = self._request("POST", "/bulk", {"ops": wire})
        if code != 200:
            raise RemoteStoreError(self._err(code, body))
        raw = body.get("results") or []
        results: List[Optional[str]] = []
        for w, r in zip(wire, raw):
            if w["op"] == "patch_col":
                if isinstance(r, list):
                    results.extend(r)  # the per-key result list
                else:
                    # an op-level failure: one string for the whole run
                    results.extend([r] * len(w["keys"]))
            else:
                results.append(r)
        if len(raw) != len(wire) or len(results) != len(ops):
            raise RemoteStoreError(f"bulk returned {len(results)} results for {len(ops)} ops")
        return results

    @property
    def segment_shards(self) -> int:
        """The server's partitioned-bus shard count (``/healthz``
        ``shards``), read once and cached until a reconnect.  The async
        applier splits a cycle's segment by namespace shard and ships the
        sub-segments concurrently when it is above 1."""
        if self._segment_shards is None:
            code, body = self._request("GET", "/healthz")
            if code != 200:
                raise RemoteStoreError(self._err(code, body))
            self._segment_shards = max(1, int(body.get("shards", 1)))
        return self._segment_shards

    @property
    def proc_shard_map(self) -> Optional[List[str]]:
        """The process mesh's shard map: None (ROADMAP item 11b part 4)."""
        return None

    def apply_segment(self, seg, shard: Optional[int] = None) -> Dict[str, Any]:
        """Ship one columnar decision segment (``store/segment.py``) in ONE
        request: the whole cycle's binds, evictions and their Events as
        parallel columns over interned string tables.  The server applies
        it under one lock hold, lazily; on a partitioned server ``shard``
        routes a sub-segment to that shard's apply lock, WAL and watch
        slice.  Returns the sparse per-row error dict ``{"binds": [[row,
        err], ...], "evicts": [...], "timings": {...}}``; raises on a
        transport failure (no blind retry here: the applier owns the one
        re-ship)."""
        op = seg.to_wire()
        if shard is not None:
            op["shard"] = int(shard)
        code, body = self._request("POST", "/bulk", {"ops": [op]})
        if code != 200:
            raise RemoteStoreError(self._err(code, body))
        res = (body.get("results") or [None])[0]
        if not isinstance(res, dict):
            raise RemoteStoreError(str(res) if res else "segment op dropped")
        return res

    def delete(self, kind: str, key: str) -> Optional[Any]:
        before = self.get(kind, key)
        code, body = self._request("DELETE", f"/apis/{kind}/obj?key={quote(key, safe='')}")
        if code == 422:
            raise AdmissionError(self._err(code, body))
        if code != 200:
            raise RemoteStoreError(self._err(code, body))
        return before if body.get("deleted") else None

    def get(self, kind: str, key: str) -> Optional[Any]:
        code, body = self._request("GET", f"/apis/{kind}/obj?key={quote(key, safe='')}")
        if code == 404:
            return None
        if code != 200:
            raise RemoteStoreError(self._err(code, body))
        return decode_object(kind, body["object"])

    def list(self, kind: str) -> List[Any]:
        code, body = self._request("GET", f"/apis/{kind}")
        if code != 200:
            raise RemoteStoreError(self._err(code, body))
        return [decode_object(kind, item) for item in body["items"]]

    def items(self, kind: str):
        return iter(self.list(kind))

    @property
    def resource_version(self) -> int:
        """The server's event sequence, monotonic like
        ``Store.resource_version``."""
        code, body = self._request("GET", "/watch?since=-1&timeout=0")
        if code != 200:
            raise RemoteStoreError(self._err(code, body))
        return body["next"]

    @property
    def uid(self) -> Optional[str]:
        """The backing store's lineage id (``Store.uid`` over the wire): a
        mirror checkpoint refuses another store's."""
        code, body = self._request("GET", "/healthz")
        if code != 200:
            raise RemoteStoreError(self._err(code, body))
        return body.get("uid")

    # -- watch -------------------------------------------------------------------

    def watch(self, kind: str) -> _RemoteWatchQueue:
        if not self._watches:
            # informer semantics: watches deliver the events from now on,
            # the subscriber lists the current state itself
            self._cursor = self.resource_version
        q = _RemoteWatchQueue(self, kind)
        self._watches.setdefault(kind, []).append(q)
        return q

    def poll(self, timeout: float = 0.0) -> int:
        """Fetch the events after the cursor into the local queues; returns
        how many arrived.  Raises StaleWatch (with the cursor moved to the
        server's head) when the server dropped events this client missed."""
        if not self._watches:
            return 0
        kinds = ",".join(sorted(self._watches))
        shard_arg = f"&shard={self.shard}" if self.shard is not None else ""
        code, body = self._request(
            "GET", f"/watch?since={self._cursor}&kinds={kinds}&timeout={timeout}{shard_arg}")
        if code != 200:
            raise RemoteStoreError(self._err(code, body))
        if body.get("relist"):
            self._cursor = body["next"]
            raise StaleWatch("watch cursor fell off the server log; relist")
        events = body.get("events") or []
        for e in events:
            kind = e["kind"]
            ev = _WireEvent(kind, EventType(e["type"]), decode_object(kind, e["object"]),
                            e.get("old") or None, e["object"])
            for q in self._watches.get(kind, []):
                q.append(ev)
        self._cursor = max(self._cursor, body.get("next", self._cursor))
        return len(events)

    def pending_events(self) -> bool:
        self.poll()
        return any(q._buf for qs in self._watches.values() for q in qs)


def wait_healthy(url: str, timeout: float = 30.0, request_timeout: float = 2.0) -> bool:
    """Poll ``GET /healthz`` with jittered backoff (``backoff.Backoff``)
    until the server answers or ``timeout`` passes; returns whether it came
    up."""
    from volcano_tpu_torch.backoff import Backoff

    store = RemoteStore(url, timeout=request_timeout)
    deadline = time.monotonic() + timeout
    bo = Backoff(base=0.05, cap=1.0)
    while True:
        try:
            code, _ = store._request("GET", "/healthz")
            if code == 200:
                return True
        except (OSError, http.client.HTTPException):
            pass
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return False
        time.sleep(min(bo.next(), remaining))

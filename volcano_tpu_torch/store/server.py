"""The store server: an HTTP "API server" hosting the watchable Store.

The port's copy of ``volcano_tpu/store/server.py``.  The
reference's components never talk to each other directly: they watch and
write objects through the Kubernetes API server.  This server gives the
port that boundary over HTTP, so that the scheduler runs in its own OS
process against an apiserver in another:

  GET    /apis/<kind>                 list
  GET    /apis/<kind>/obj?key=<k>     get
  POST   /apis/<kind>                 create
  PUT    /apis/<kind>[?cas=<rv>]      update (compare-and-swap with cas)
  PATCH  /apis/<kind>/obj?key=<k>     patch (dotted fields, a ``when`` clause)
  DELETE /apis/<kind>/obj?key=<k>     delete
  POST   /bulk                        N ops; ``patch_col`` runs, decision segments
  GET    /watch?since=<seq>&kinds=a,b&timeout=<s>[&shard=i]   long-poll of the event log
  GET    /healthz                     liveness, the store uid, the shard count, the WAL's stats
  GET    /metrics, /debug/trace, /debug/timeseries, /debug/prof

Every mutation appends to one ordered event log; a client resumes from its
last sequence number and relists when it fell behind the buffer (the
reference's "resourceVersion too old").  A decision segment lands under one
lock hold as lazily staged rows (``Store.apply_segment_lazy``) and one log
block a section.  Durability: a state file (the etcd analogue) written by a
background saver, or at every mutation with ``save_interval <= 0``; with
``wal`` every acknowledged mutation is in the write-ahead log
(``store/wal.py``) and fsynced before its reply.  The wire is the JAX
package's, so either package's client talks to either package's server and
either server recovers the other's state directory.

``shards=N`` partitions the decision bus (``store/partition.py``): a
segment op tagged ``shard`` applies under that shard's apply lock, its log
entries carry the shard (``/watch?shard=i`` serves one shard's slice), and
with ``wal`` each shard has a WAL directory of its own whose tails recovery
merges by ``seq``.

Not here yet, each refused by name: the digest audit and ``/debug/digest``
(ROADMAP item 11b part 2), replication and ``/repl/*`` (part 3), the shared
seq bus and the process mesh (part 4); ``/chaos`` (item 13); the Job kind
and its admission (item 12).

This process imports no torch at start and never initializes CUDA: the
card belongs to the scheduler.  ``python -m volcano_tpu_torch.store.server``
runs one (``--help``); SIGTERM flushes the state and the WAL before exit.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from volcano_tpu_torch import timeseries, trace
from volcano_tpu_torch.store.codec import (
    KIND_CLASSES,
    decode_fields,
    decode_object,
    encode,
    unknown_kind,
)
from volcano_tpu_torch.store.partition import shard_of_key
from volcano_tpu_torch.store.store import PreconditionFailed, Store

#: cap on buffered event rows; a client further behind must relist
LOG_CAP = 100_000

#: what the routes and options of later parts answer with
LATER_DIGEST = "comes with the digest audit (ROADMAP item 11b part 2)"
LATER_REPL = "comes with replication (ROADMAP item 11b part 3)"
LATER_MESH = "comes with the process mesh (ROADMAP item 11b part 4)"
LATER_13 = "fault injection (/chaos) comes with the tooling (ROADMAP item 13)"


def _traced(verb: str):
    """Continue the client's ``X-Volcano-Trace`` context around one request
    verb: the request span parents to the caller's span across the process
    boundary.  Disarmed it costs one attribute check; the ``/debug/*`` and
    ``/metrics`` endpoints are never traced (reading the flight recorder
    must not write to it), nor are requests without the header."""

    def deco(fn):
        def handler(self):
            if trace.TRACER is None:
                return fn(self)
            path = self.path
            if path.startswith("/debug/") or path.startswith("/metrics"):
                return fn(self)
            header = self.headers.get(trace.HEADER, "")
            if not header:
                return fn(self)
            trace.set_component("apiserver")
            with trace.request_context(header, f"store.{verb}", path=path.split("?", 1)[0]):
                return fn(self)

        return handler

    return deco


class StoreServer:
    def __init__(
        self,
        store: Optional[Store] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        state_path: Optional[str] = None,
        save_interval: float = 0.25,
        wal=None,
        shards: int = 1,
        repl: Optional[Dict[str, Any]] = None,
        seq_bus=None,
        proc_shard: Optional[tuple] = None,
    ):
        if repl is not None:
            raise ValueError(f"repl: {LATER_REPL}")
        if seq_bus is not None or proc_shard is not None:
            raise ValueError(f"seq_bus / proc_shard: {LATER_MESH}")
        self.store = store or Store()
        # lock order: _flush_lock before lock, and a shard's apply lock
        # before lock; never the reverse
        self.lock = threading.RLock()
        self.cond = threading.Condition(self.lock)
        # the partitioned decision bus: the shard count of the segment
        # stream, the WAL and the watch slices (1: the unpartitioned server
        # byte for byte).  A shard's apply lock keeps its sub-segments in
        # ship order; the applies of two shards still serialize on the
        # server lock, and overlap in what lies outside it (the request's
        # decode, the reply, the shard's own WAL fsync)
        self.shards = max(1, int(shards))
        self._shard_locks = [threading.RLock() for _ in range(self.shards)]
        #: the newest seq that touched each shard (an untagged entry
        #: touches every shard)
        self._shard_seq = [0] * self.shards
        # the ordered event log: per-event dict entries, or columnar block
        # entries {"seq": the last row's seq, "n": rows, "kind": K,
        # "block": PatchLogBlock | EventLogBlock, "start": the first row}
        # appended by the segment verb, one a segment section
        self.log: List[Dict[str, Any]] = []
        #: event rows buffered (a block counts its rows): the relist
        #: horizon is ``seq - _log_rows``
        self._log_rows = 0
        self.seq = 0
        # durability (the etcd analogue): the objects and the sequence
        # persist to ``state_path``; the event log does not (clients behind
        # a restart relist).  With save_interval > 0 a mutation is
        # acknowledged before the saver writes it; save_interval <= 0
        # flushes the state file before every reply.  ``wal`` (True: the
        # directory ``<state_path>.wal``, or a directory path) appends
        # every mutation's wire form to the write-ahead log and fsyncs it
        # before the 2xx; the state file is then its checkpoint
        self.state_path = state_path
        self.save_interval = save_interval
        self.wal = None
        if wal:
            if state_path is None:
                raise ValueError("wal requires state_path (the WAL checkpoints into "
                                 "the state file)")
            wal_dir = wal if isinstance(wal, str) else state_path + ".wal"
            if self.shards > 1:
                # one WAL a shard, each with its own group-commit fsync
                from volcano_tpu_torch.store.partition import ShardedWAL

                self.wal = ShardedWAL(wal_dir, self.shards)
            else:
                from volcano_tpu_torch.store.wal import WriteAheadLog

                self.wal = WriteAheadLog(wal_dir)
        self._sync_persist = (state_path is not None and save_interval <= 0
                              and self.wal is None)
        self._dirty_kinds: set = set()
        # serializes whole flushes (the saver against the shutdown flush):
        # a staler snapshot never overwrites a fresher one
        self._flush_lock = threading.Lock()
        # per-kind encoded cache: only the kinds dirtied since the last
        # flush are encoded anew
        self._enc_cache: Dict[str, List[Any]] = {}
        # per-object encoded cache, kept by event delta in _pump_log: list
        # replies and the event log serve from it
        self._obj_enc: Dict[tuple, Dict[str, Any]] = {}
        # its lazy half: (kind, key) -> (log block, row) for objects whose
        # newest state is an unexpanded segment row (_enc_of resolves it)
        self._enc_pending: Dict[tuple, tuple] = {}
        # create / update stage the request's own wire dict here (meta
        # restamped) so _pump_log seeds the cache without an encode;
        # cleared after every pump
        self._enc_hints: Dict[tuple, Dict[str, Any]] = {}
        self._saver_stop = threading.Event()
        #: set by kill(): a crashed process cannot checkpoint
        self._killed = False
        self._saver: Optional[threading.Thread] = None
        # recovery may checkpoint before the watch queues register below
        self._queues: Dict[str, Any] = {}
        if state_path is not None:
            self._load_state()
            if not self._sync_persist:
                self._saver = threading.Thread(target=self._saver_loop, daemon=True)
                self._saver.start()
        self._queues = {kind: self.store.watch(kind) for kind in KIND_CLASSES}

        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_text(self, code: int, body: bytes,
                            ctype: str = "text/plain; version=0.0.4") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> Dict[str, Any]:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def _later(self, path: str) -> bool:
                """Answer the routes of later items with a 404 naming the
                item (the request body, if any, is drained first)."""
                if path == "/chaos":
                    msg = LATER_13
                elif path.startswith("/repl/"):
                    msg = f"{path} {LATER_REPL}"
                elif path == "/debug/digest":
                    msg = f"{path} {LATER_DIGEST}"
                else:
                    return False
                n = int(self.headers.get("Content-Length", 0) or 0)
                if n:
                    self.rfile.read(n)
                self._reply(404, {"error": msg})
                return True

            def _unknown(self, kind: str) -> bool:
                if kind in KIND_CLASSES:
                    return False
                n = int(self.headers.get("Content-Length", 0) or 0)
                if n:
                    self.rfile.read(n)
                self._reply(422, {"error": unknown_kind(kind)})
                return True

            @_traced("GET")
            def do_GET(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                parts = [p for p in u.path.split("/") if p]
                if self._later(u.path):
                    return
                if u.path == "/debug/trace":
                    return self._reply(200, trace.debug_payload())
                if u.path == "/debug/timeseries":
                    return self._reply(200, timeseries.debug_payload())
                if u.path == "/debug/prof":
                    # vtprof imports torch: only this handler loads it
                    from volcano_tpu_torch import vtprof

                    return self._reply(200, vtprof.debug_payload())
                if u.path == "/metrics":
                    from volcano_tpu_torch.scheduler import metrics

                    return self._reply_text(200, metrics.expose_text().encode())
                if u.path == "/healthz":
                    payload = {"ok": True, "uid": server.store.uid, "shards": server.shards}
                    if server.wal is not None:
                        payload["wal"] = server.wal.stats()
                    return self._reply(200, payload)
                if u.path == "/watch":
                    since = int(q.get("since", ["0"])[0])
                    kinds = set(q.get("kinds", [""])[0].split(",")) - {""}
                    timeout = float(q.get("timeout", ["0"])[0])
                    shard_q = q.get("shard", [None])[0]
                    return self._reply(200, server.watch_since(
                        since, kinds, timeout,
                        shard=int(shard_q) if shard_q is not None else None))
                if len(parts) == 2 and parts[0] == "apis":
                    kind = parts[1]
                    if self._unknown(kind):
                        return
                    with server.lock:
                        # drain queued events first: a write that bypassed
                        # the handlers must not leave a stale cached encoding
                        server._pump_log()
                        enc_of = server._enc_of
                        items = [enc_of(kind, o.meta.key) or encode(o)
                                 for o in server.store.list(kind)]
                    return self._reply(200, {"items": items, "seq": server.seq})
                if len(parts) == 3 and parts[0] == "apis" and parts[2] == "obj":
                    key = q.get("key", [""])[0]
                    with server.lock:
                        obj = server.store.get(parts[1], key)
                    if obj is None:
                        return self._reply(404, {"error": "not found"})
                    return self._reply(200, {"object": encode(obj)})
                return self._reply(404, {"error": f"no route {u.path}"})

            @_traced("POST")
            def do_POST(self):
                u = urlparse(self.path)
                parts = [p for p in u.path.split("/") if p]
                if self._later(u.path):
                    return
                if u.path == "/bulk":
                    try:
                        body = self._body()
                        results = server.bulk(body.get("ops") or [])
                        code, payload = 200, {"results": results}
                    except Exception as e:  # noqa: BLE001 — wire boundary
                        code, payload = 500, {"error": repr(e)}
                    return self._reply(code, payload)
                if len(parts) == 2 and parts[0] == "apis":
                    if self._unknown(parts[1]):
                        return
                    try:
                        code, payload = server.create(parts[1], self._body())
                        if code < 400:  # a failed verb wrote nothing
                            server._commit_ack()
                    except Exception as e:  # noqa: BLE001 — wire boundary
                        code, payload = 500, {"error": repr(e)}
                    return self._reply(code, payload)
                return self._reply(404, {"error": "no route"})

            @_traced("PATCH")
            def do_PATCH(self):
                u = urlparse(self.path)
                parts = [p for p in u.path.split("/") if p]
                q = parse_qs(u.query)
                if self._later(u.path):
                    return
                if len(parts) == 3 and parts[0] == "apis" and parts[2] == "obj":
                    if self._unknown(parts[1]):
                        return
                    key = q.get("key", [""])[0]
                    try:
                        body = self._body()
                        code, payload = server.patch(parts[1], key, body.get("fields") or {},
                                                     when=body.get("when"))
                        if code < 400:
                            server._commit_ack()
                    except Exception as e:  # noqa: BLE001 — wire boundary
                        code, payload = 500, {"error": repr(e)}
                    return self._reply(code, payload)
                return self._reply(404, {"error": "no route"})

            @_traced("PUT")
            def do_PUT(self):
                u = urlparse(self.path)
                parts = [p for p in u.path.split("/") if p]
                q = parse_qs(u.query)
                if self._later(u.path):
                    return
                if len(parts) == 2 and parts[0] == "apis":
                    if self._unknown(parts[1]):
                        return
                    cas = q.get("cas", [None])[0]
                    try:
                        code, payload = server.update(
                            parts[1], self._body(),
                            expected_rv=int(cas) if cas is not None else None)
                        if code < 400:
                            server._commit_ack()
                    except Exception as e:  # noqa: BLE001 — wire boundary
                        code, payload = 500, {"error": repr(e)}
                    return self._reply(code, payload)
                return self._reply(404, {"error": "no route"})

            @_traced("DELETE")
            def do_DELETE(self):
                u = urlparse(self.path)
                parts = [p for p in u.path.split("/") if p]
                q = parse_qs(u.query)
                if self._later(u.path):
                    return
                if len(parts) == 3 and parts[0] == "apis" and parts[2] == "obj":
                    if self._unknown(parts[1]):
                        return
                    key = q.get("key", [""])[0]
                    with server.lock:
                        obj = server.store.delete(parts[1], key)
                        server._pump_log()
                        if obj is not None and server.wal is not None:
                            server._wal_append({"op": "delete", "kind": parts[1], "key": key})
                    try:
                        server._commit_ack()
                    except Exception as e:  # noqa: BLE001 — wire boundary
                        return self._reply(500, {"error": repr(e)})
                    return self._reply(200, {"deleted": obj is not None})
                return self._reply(404, {"error": "no route"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread: Optional[threading.Thread] = None

    # -- mutations (from the handler threads) -----------------------------------

    def _maybe_flush(self) -> None:
        """The sync-persist flush, called after a mutation verb returns and
        outside the server lock (the flusher takes _flush_lock first)."""
        if self._sync_persist:
            self.flush_state()

    def _wal_append(self, rec: Dict[str, Any]) -> None:
        """Append one mutation record (its wire form) to the WAL, stamped
        with the post-op seq and rv so that recovery resumes the same line.
        Under the server lock, after the op's ``_pump_log``: append order is
        apply order.  The fsync comes later, in ``_commit_ack``."""
        rec["seq"] = self.seq
        rec["rv"] = self.store._rv
        self.wal.append(rec)
        from volcano_tpu_torch.scheduler import metrics

        metrics.register_wal_append()

    def _commit_ack(self) -> None:
        """The durability barrier between a mutation and its 2xx: the
        group-commit fsync of the WAL tail, then the sync-persist flush."""
        if self.wal is not None:
            self.wal.commit()
        self._maybe_flush()

    def create(self, kind: str, data: Dict[str, Any], _encode_response: bool = True):
        if kind not in KIND_CLASSES:
            return 422, {"error": unknown_kind(kind)}
        obj = decode_object(kind, data.get("object", {}))
        with self.lock:
            if self.store.get(kind, obj.meta.key) is not None:
                return 409, {"error": f"{kind} {obj.meta.key} already exists"}
            self.store.create(kind, obj)
            self._stage_enc_hint(kind, obj, data.get("object"))
            self._pump_log()
            if self.wal is not None:
                self._wal_append({"op": "create", "kind": kind,
                                  "object": self._restamped_enc(obj, data.get("object"))})
        # bulk discards per-op bodies (an encode per op was a third of a
        # 100k-op batch's server cost)
        return 201, {"object": encode(obj)} if _encode_response else {}

    def update(self, kind: str, data: Dict[str, Any], expected_rv: Optional[int] = None):
        if kind not in KIND_CLASSES:
            return 422, {"error": unknown_kind(kind)}
        obj = decode_object(kind, data.get("object", {}))
        with self.lock:
            old = self.store.get(kind, obj.meta.key)
            if old is None:
                return 404, {"error": f"{kind} {obj.meta.key} not found"}
            if expected_rv is not None and old.meta.resource_version != expected_rv:
                return 409, {
                    "error": f"{kind} {obj.meta.key}: stale resource_version "
                             f"(expected {expected_rv}, have {old.meta.resource_version})",
                    "conflict": True,
                }
            self.store.update(kind, obj)
            self._stage_enc_hint(kind, obj, data.get("object"))
            self._pump_log()
            if self.wal is not None:
                self._wal_append({"op": "update", "kind": kind,
                                  "object": self._restamped_enc(obj, data.get("object"))})
        return 200, {"object": encode(obj)}

    def patch(self, kind: str, key: str, fields: Dict[str, Any], when: Dict[str, Any] = None,
              _encode_response: bool = True):
        if kind not in KIND_CLASSES:
            return 422, {"error": unknown_kind(kind)}
        with self.lock:
            try:
                obj = self.store.patch(kind, key, decode_fields(kind, fields),
                                       when=decode_fields(kind, when) if when else None)
            except KeyError as e:
                # "NotFound:" is the vanished-object marker bulk callers match
                return 404, {"error": f"NotFound: {e}"}
            except PreconditionFailed as e:
                return 409, {"error": repr(e)}
            self._pump_log()
            if self.wal is not None:
                rec = {"op": "patch", "kind": kind, "key": key, "fields": fields}
                if when:
                    rec["when"] = when
                self._wal_append(rec)
        return 200, {"object": encode(obj)} if _encode_response else {}

    def bulk(self, ops: List[Dict[str, Any]]) -> List[Optional[str]]:
        """N mutations in one round trip (``Store.bulk``'s op shapes, objects
        encoded, plus ``patch_col`` runs and decision segments).  The lock
        is reentrant: holding it across the batch keeps the batch contiguous
        in the event log.  A bulk of one segment op, the shape the applier
        ships a sub-segment in, skips the batch's hold: the apply takes its
        shard lock, then the server lock."""
        if len(ops) == 1 and ops[0].get("op") == "segment":
            try:
                results = [self._apply_segment(ops[0])]
            except Exception as e:  # noqa: BLE001 — per-op isolation
                results = [repr(e)]
            self._commit_ack()
            return results
        results: List[Optional[str]] = []
        with self.lock:
            for op in ops:
                try:
                    verb = op.get("op")
                    kind = op.get("kind", "")
                    if verb == "create":
                        code, payload = self.create(kind, {"object": op.get("object", {})},
                                                    _encode_response=False)
                        ok = code == 201
                    elif verb == "update":
                        code, payload = self.update(kind, {"object": op.get("object", {})},
                                                    expected_rv=op.get("cas"))
                        ok = code == 200
                    elif verb == "patch":
                        code, payload = self.patch(kind, op.get("key", ""),
                                                   op.get("fields") or {}, when=op.get("when"),
                                                   _encode_response=False)
                        ok = code == 200
                    elif verb == "patch_col":
                        # a columnar patch run: its result is a per-key list
                        results.append(self._patch_col(op))
                        continue
                    elif verb == "segment":
                        # a decision segment: its result is the sparse
                        # per-row error dict.  The batch holds the server
                        # lock, which covers every shard: the shard lock is
                        # skipped, so that the order stays shard, server
                        results.append(self._apply_segment(op, _in_bulk=True))
                        continue
                    elif verb == "delete":
                        if kind not in KIND_CLASSES:
                            ok, payload = False, {"error": unknown_kind(kind)}
                        else:
                            self._bulk_delete(kind, op.get("key", ""))
                            ok, payload = True, {}
                    else:
                        ok, payload = False, {"error": f"unknown bulk op {verb!r}"}
                    results.append(None if ok else payload.get("error", "failed"))
                except Exception as e:  # noqa: BLE001 — per-op isolation
                    results.append(repr(e))
        self._commit_ack()
        return results

    def _bulk_delete(self, kind: str, key: str) -> None:
        """One bulk delete, mutation through WAL append in one frame: the
        batch loop swallows a failure and acknowledges the batch, so the
        window between them must not span its statements."""
        deleted = self.store.delete(kind, key)
        self._pump_log()
        if deleted is not None and self.wal is not None:
            self._wal_append({"op": "delete", "kind": kind, "key": key})

    def _patch_col(self, op: Dict[str, Any]) -> List[Optional[str]]:
        """Expand one columnar patch op: a kind, a keys array, per-field
        value columns and constants, a shared ``when``.  The field decoders
        resolve once for the run; the values are scalars, so no decoded
        object is shared across rows."""
        kind = op.get("kind", "")
        keys = op.get("keys") or []
        if kind not in KIND_CLASSES:
            return [unknown_kind(kind)] * len(keys)
        cols = op.get("columns") or {}
        const_enc = op.get("const") or {}
        when = op.get("when")
        const = decode_fields(kind, const_enc) if const_enc else {}
        when_dec = decode_fields(kind, when) if when else None
        col_dec = self._col_decoders(kind, cols)
        out: List[Optional[str]] = []
        with self.lock:
            for i, key in enumerate(keys):
                try:
                    fields = dict(const)
                    for f, vals in cols.items():
                        fields[f] = col_dec[f](vals[i])
                    self.store.patch(kind, key, fields, when=when_dec)
                    out.append(None)
                except KeyError as e:
                    out.append(f"NotFound: {e}")
                except Exception as e:  # noqa: BLE001 — per-key isolation
                    out.append(repr(e))
            self._pump_log()
            if self.wal is not None:
                # ONE record for the run, its wire form verbatim: per-key
                # failures replay to the same outcome
                self._wal_append({k: op[k] for k in
                                  ("op", "kind", "keys", "columns", "const", "when")
                                  if k in op})
        return out

    @staticmethod
    def _col_decoders(kind: str, cols) -> Dict[str, Any]:
        """Per-field decoders of a columnar patch run, resolved once (the
        live verb and WAL replay share them)."""
        from volcano_tpu_torch.store.codec import _decoder, _resolve_hint

        cls = KIND_CLASSES.get(kind)
        col_dec: Dict[str, Any] = {}
        for f in cols:
            hint = _resolve_hint(cls, f) if cls is not None else None
            col_dec[f] = _decoder(hint) if hint is not None else (lambda v: v)
        return col_dec

    def _apply_segment(self, op: Dict[str, Any], _in_bulk: bool = False,
                       stamp: Optional[float] = None) -> Dict[str, Any]:
        """Apply one columnar decision segment: the cycle's binds, evictions
        and Events land under ONE lock hold, with no per-object store
        write, encode or log entry.  The store stages the rows lazily
        (``Store.apply_segment_lazy``); here one log block a section is
        appended, which is both the watch encoding (expanded on read,
        shared by every watcher) and the encoded-object cache entry of
        every key it covers (``_enc_of``).  The segment applies whole or
        not at all; it never flushes inline (the bulk wrapper's
        ``_commit_ack`` runs outside the lock).

        On a partitioned server the op's ``shard`` tag picks the apply lock
        (taken before the server lock, skipped inside a held bulk), the WAL
        and the tag of its log entries.  An untagged segment (a client that
        does not split) locks and logs durably as shard 0, and its entries
        stay untagged, so that every shard's watchers receive its rows."""
        from contextlib import nullcontext

        from volcano_tpu_torch.store.segment import DecisionSegment, PatchLogBlock

        seg = DecisionSegment.from_wire(op)
        shard_tag = op.get("shard")
        shard = int(shard_tag) % self.shards if shard_tag is not None else 0
        shard_lock = nullcontext() if _in_bulk else self._shard_locks[shard]
        with shard_lock, self.lock:
            # queued per-object events keep their place in the order
            self._pump_log()
            if stamp is None:
                stamp = time.time()
            res = self.store.apply_segment_lazy(seg, stamp=stamp)
            bkeys, bvals, rv_b0 = res.pop("bind_block")
            ekeys, rv_e0 = res.pop("evict_block")
            ebind, eevict = res.pop("event_blocks")
            pend = self._enc_pending
            if bkeys:
                pre = [self._enc_pre("Pod", k) for k in bkeys]
                blk = PatchLogBlock("node_name", bkeys, bvals, pre, rv_b0)
                self._append_block(blk, shard_tag)
                for i, k in enumerate(bkeys):
                    pend[("Pod", k)] = (blk, i)
                self._dirty_kinds.add("Pod")
            if ekeys:
                pre = [self._enc_pre("Pod", k) for k in ekeys]
                blk = PatchLogBlock("deleting", ekeys, [True] * len(ekeys), pre, rv_e0)
                self._append_block(blk, shard_tag)
                for i, k in enumerate(ekeys):
                    pend[("Pod", k)] = (blk, i)
                self._dirty_kinds.add("Pod")
            for blk in (ebind, eevict):
                if len(blk):
                    self._append_block(blk, shard_tag)
                    for i in range(len(blk)):
                        pend[("Event", blk.key(i))] = (blk, i)
                    self._dirty_kinds.add("Event")
            self._trim_log()
            if self.wal is not None:
                # the WHOLE cycle is one WAL record: the wire op verbatim and
                # the Event stamp, so replay reproduces the same lazy apply;
                # the shard tag routes it to that shard's WAL
                rec = dict(op)
                rec["stamp"] = stamp
                rec["shard"] = shard
                self._wal_append(rec)
            self.cond.notify_all()
        return res

    def _append_block(self, blk, shard=None) -> None:
        """One log entry for a whole columnar block; its rows hold the seq
        range ``blk.seq0 .. entry["seq"]``.  On a partitioned server the
        entry carries its shard (``/watch?shard=i`` serves and expands only
        that shard's blocks); ``shard=None``, a cross-shard segment, leaves
        it untagged, served to every shard's watchers."""
        n = len(blk)
        self.seq += n
        blk.seq0 = self.seq - n + 1
        self._log_rows += n
        entry = {"seq": self.seq, "n": n, "kind": blk.kind, "block": blk, "start": 0}
        if self.shards > 1 and shard is not None:
            entry["shard"] = int(shard) % self.shards
            self._note_watermark(entry["shard"], self.seq)
        else:
            # every shard's stream carries an untagged block
            for s in range(self.shards):
                self._note_watermark(s, self.seq)
        self.log.append(entry)

    def _note_watermark(self, shard: int, seq: int) -> None:
        """Advance shard ``shard``'s newest seq (a monotone max)."""
        marks = self._shard_seq
        s = int(shard) % len(marks)
        if seq > marks[s]:
            marks[s] = seq

    def _enc_of(self, kind: str, key: str) -> Optional[Dict[str, Any]]:
        """The object's current encoding, resolving the lazy columnar half of
        the cache on the first read (memoized on the block)."""
        ck = (kind, key)
        p = self._enc_pending.pop(ck, None)
        if p is not None:
            blk, i = p
            self._obj_enc[ck] = blk.materialize_enc(i)
        return self._obj_enc.get(ck)

    def _enc_pre(self, kind: str, key: str) -> Dict[str, Any]:
        """The pre-segment encoding of ``key``: the delta basis (and the
        ``old``) of a block row about to cover it.  A cache miss reads the
        raw store object (never Store.get, which would fold the rows this
        segment just staged)."""
        enc = self._enc_of(kind, key)
        if enc is None:
            enc = encode(self.store._objects[kind][key])
            self._obj_enc[(kind, key)] = enc
        return enc

    def _trim_log(self) -> None:
        """Evict the oldest rows past LOG_CAP.  A block straddling the
        horizon stays with its ``start`` / ``n`` advanced (a shallow copy
        of the entry; the block is shared with slower readers)."""
        overflow = self._log_rows - LOG_CAP
        if overflow <= 0:
            return
        k = 0
        log = self.log
        while overflow > 0 and k < len(log):
            e = log[k]
            n = e.get("n", 1)
            if n <= overflow:
                overflow -= n
                self._log_rows -= n
                k += 1
            else:
                e2 = dict(e)
                e2["n"] = n - overflow
                e2["start"] = e.get("start", 0) + overflow
                log[k] = e2
                self._log_rows -= overflow
                overflow = 0
        if k:
            del log[:k]

    # -- persistence -------------------------------------------------------------

    def _load_state(self) -> None:
        """Recovery: the snapshot, then the WAL tail replayed on top (torn
        tails tolerated, ``store/wal.py``); a ``store.recover`` span when
        tracing is armed."""
        if trace.TRACER is None:
            self._recover()
            return
        with trace.span("store.recover", path=self.state_path) as sp:
            replayed, skipped = self._recover()
            sp.annotate(replayed=replayed, skipped=skipped,
                        torn_tails=self.wal.torn_tails if self.wal else 0)

    def _recover(self):
        data = {}
        if os.path.exists(self.state_path):
            with open(self.state_path) as f:
                data = json.load(f)
        self._load_snapshot(data)
        replayed = skipped = 0
        if self.wal is not None:
            if data and "wal_floor" not in data:
                # a snapshot without a floor was written by a WAL-off life
                # (a WAL-on life stamps one before serving): any leftover
                # segments predate it, and replaying them would resurrect
                # older values; so would segments in a layout this life's
                # WAL does not own (a shard-count change ago)
                self.wal.drop_all()
                self._drop_foreign_wal(data)
            else:
                replayed, skipped = self._replay_wal(data)
                if replayed:
                    from volcano_tpu_torch.scheduler import metrics

                    metrics.register_wal_recovery(replayed)
            if data and "wal_floor" not in data:
                # stamp the floor before any request is served (forced: an
                # inherited snapshot with no objects needs it too)
                self._dirty_kinds.update(data.get("kinds", {}))
                self.flush_state(force=True)
        else:
            replayed, skipped = self._absorb_leftover_wal(data)
        return replayed, skipped

    def _wal_floor_of(self, data):
        """The snapshot's WAL floor in the shape this life's WAL speaks: an
        int for the single log, a list (one a shard) for the partitioned
        bus.  A floor another shard count stamped reads as 0, replay all
        (the records apply idempotently over the snapshot)."""
        floor = data.get("wal_floor", 0)
        if getattr(self.wal, "nshards", 1) > 1:
            return floor if isinstance(floor, list) else 0
        return 0 if isinstance(floor, list) else int(floor)

    @staticmethod
    def _read_tails(sources, pending):
        """Append ``(seq, tiebreak, rec)`` for every record at or above its
        floor in each ``(dir, floor)`` of ``sources`` to ``pending``;
        returns every segment file found (the covered ones too), as
        ``(dir, path)``."""
        from volcano_tpu_torch.store import wal as walmod

        files = []
        for src_dir, floor in sources:
            for idx in walmod.list_segment_indices(src_dir):
                path = os.path.join(src_dir, f"{idx:08d}.wal")
                files.append((src_dir, path))
                if idx < floor:
                    continue  # covered by the snapshot: reaped, not replayed
                records, _torn = walmod.read_records(path)
                for rec in records:
                    pending.append((int(rec.get("seq", 0)), len(pending), rec))
        return files

    def _apply_tail(self, pending):
        """Replay ``pending`` in seq order, resuming the seq / rv line each
        record was acknowledged under; returns (replayed, skipped): a
        record that cannot apply is skipped and counted, never fatal."""
        pending.sort(key=lambda t: (t[0], t[1]))
        replayed = skipped = 0
        for _, _, rec in pending:
            replayed += 1
            try:
                self._replay_record(rec)
            except Exception:  # noqa: BLE001 — recovery must not die
                skipped += 1
            self._continue_line(rec)
        return replayed, skipped

    def _retire(self, files) -> None:
        """Make the absorbed records durable in a snapshot, then unlink
        their segment ``files``; a crash in between absorbs them again next
        boot, idempotently."""
        from volcano_tpu_torch.store import wal as walmod

        self.flush_state(force=True)
        touched = set()
        for src_dir, path in files:
            try:
                os.unlink(path)
            except OSError:
                pass
            touched.add(src_dir)
        for src_dir in sorted(touched):
            walmod.fsync_dir(src_dir)

    def _absorb_leftover_wal(self, data):
        """A WAL-off boot beside leftover WAL segments: a WAL-on life
        crashed with acknowledged records past its last checkpoint.  Replay
        them (the top-level log and every shard's, merged by seq), snapshot
        at once so they are durable again, then retire the segments."""
        from volcano_tpu_torch.store.partition import leftover_shard_dirs

        wal_dir = self.state_path + ".wal"
        floor_raw = data.get("wal_floor", 0)
        floors = floor_raw if isinstance(floor_raw, list) else []
        flat = 0 if isinstance(floor_raw, list) else int(floor_raw)
        sources = [(wal_dir, flat)] + [
            (d, int(floors[i]) if i < len(floors) else 0)
            for i, d in enumerate(leftover_shard_dirs(wal_dir))]
        pending = []
        files = self._read_tails(sources, pending)
        if not files:
            return 0, 0
        replayed, skipped = self._apply_tail(pending)
        if replayed:
            from volcano_tpu_torch.scheduler import metrics

            metrics.register_wal_recovery(replayed)
        self._retire(files)
        return replayed, skipped

    def _foreign_wal_sources(self, data):
        """``[(dir, floor)]`` of the WAL locations a shard-count change left
        behind: a single-log life owns the top level and leaves every shard
        directory; an N-shard life owns ``s00 .. s{N-1}`` and leaves the top
        level and any wider life's higher shards.  A floor comes from the
        snapshot in the shape the leaving life stamped it (entry i for
        ``s{i}``, the int for the top level); without one, 0."""
        from volcano_tpu_torch.store.partition import leftover_shard_dirs

        nshards_now = getattr(self.wal, "nshards", 1)
        floor_raw = data.get("wal_floor", 0) if data else 0
        floors = floor_raw if isinstance(floor_raw, list) else []
        flat = 0 if isinstance(floor_raw, list) else int(floor_raw)
        sources = [] if nshards_now == 1 else [(self.wal.dir, flat)]
        for d in leftover_shard_dirs(self.wal.dir):
            i = int(os.path.basename(d)[1:])
            if nshards_now == 1 or i >= nshards_now:
                sources.append((d, int(floors[i]) if i < len(floors) else 0))
        return sources

    def _drop_foreign_wal(self, data) -> None:
        """Unlink every segment of the layouts this life does not own (they
        predate a snapshot a WAL-off life wrote)."""
        from volcano_tpu_torch.store import wal as walmod

        for src_dir, _floor in self._foreign_wal_sources(data):
            dropped = False
            for idx in walmod.list_segment_indices(src_dir):
                try:
                    os.unlink(os.path.join(src_dir, f"{idx:08d}.wal"))
                    dropped = True
                except OSError:
                    pass
            if dropped:
                walmod.fsync_dir(src_dir)

    def _continue_line(self, rec: Dict[str, Any]) -> None:
        """Resume the seq / rv line a replayed record was acknowledged under:
        watch cursors from before the crash relist, CAS holders go on."""
        if "seq" in rec:
            self.seq = max(self.seq, int(rec["seq"]))
        if "rv" in rec:
            self.store._rv = max(self.store._rv, int(rec["rv"]))

    def _load_snapshot(self, data) -> None:
        max_rv = 0
        for kind, items in data.get("kinds", {}).items():
            if kind not in KIND_CLASSES:
                raise ValueError(f"the state file holds {len(items)} objects of "
                                 f"{unknown_kind(kind)}")
            # seed the encoded caches with the loaded payload: the
            # incremental flush builds the file from them, and the first
            # segment after a restart reads its delta bases there
            self._enc_cache[kind] = list(items)
            for enc in items:
                obj = decode_object(kind, enc)
                self._obj_enc[(kind, obj.meta.key)] = enc
                rv = obj.meta.resource_version
                self.store.create(kind, obj)
                # create stamps a fresh rv: restore the persisted one on the
                # object and its shadow, or the first unchanged write after
                # a restart would fan out a phantom update
                obj.meta.resource_version = rv
                shadow = self.store._shadow[kind].get(obj.meta.key)
                if shadow is not None:
                    shadow.meta.resource_version = rv
                max_rv = max(max_rv, rv)
        # writes continue the persisted version line (CAS, epoch caches)
        self.store._rv = max(self.store._rv, max_rv, int(data.get("rv", 0)))
        self.seq = int(data.get("seq", 0))
        # a restarted server is the same store lineage
        uid = data.get("store_uid")
        if uid:
            self.store.uid = uid

    def _replay_wal(self, data):
        """Replay the WAL tail through the store verbs, before any watch
        queue exists (clients behind the crash relist): this life's own
        layout (segments at or above the snapshot's floor) merged by seq
        with any tail a shard-count change left in another layout (a
        ``--shards 4`` life's acknowledged records survive a ``--shards 1``
        boot and the reverse).  The other layout's segments are then
        snapshotted and retired.  Returns (replayed, skipped)."""
        pending = []
        for rec in self.wal.replay(self._wal_floor_of(data)):
            pending.append((int(rec.get("seq", 0)), len(pending), rec))
        foreign = self._read_tails(self._foreign_wal_sources(data), pending)
        out = self._apply_tail(pending)
        if foreign:
            self._retire(foreign)
        return out

    def _replay_record(self, rec: Dict[str, Any]) -> None:
        """Apply one WAL record, its wire form with the server-stamped meta
        it was logged with (the rv restored on the object and its shadow,
        as in the snapshot load)."""
        op = rec.get("op")
        kind = rec.get("kind", "")
        store = self.store
        if op in ("create", "update"):
            enc = rec["object"]
            obj = decode_object(kind, enc)
            rv = obj.meta.resource_version
            try:
                if op == "create":
                    store.create(kind, obj)
                else:
                    store.update(kind, obj)
            except KeyError:
                # the snapshot already reflects a later life of this key:
                # converge on the record's object either way
                if op == "create":
                    store.update(kind, obj)
                else:
                    store.create(kind, obj)
            obj.meta.resource_version = rv
            shadow = store._shadow[kind].get(obj.meta.key)
            if shadow is not None:
                shadow.meta.resource_version = rv
            self._obj_enc[(kind, obj.meta.key)] = enc
            self._dirty_kinds.add(kind)
        elif op == "patch":
            when = rec.get("when")
            try:
                store.patch(kind, rec["key"], decode_fields(kind, rec.get("fields") or {}),
                            when=decode_fields(kind, when) if when else None)
            except (KeyError, PreconditionFailed):
                pass  # replays as it resolved live
            self._obj_enc.pop((kind, rec["key"]), None)
            self._dirty_kinds.add(kind)
        elif op == "patch_col":
            cols = rec.get("columns") or {}
            const_enc = rec.get("const") or {}
            when = rec.get("when")
            const = decode_fields(kind, const_enc) if const_enc else {}
            when_dec = decode_fields(kind, when) if when else None
            col_dec = self._col_decoders(kind, cols)
            for i, key in enumerate(rec.get("keys") or []):
                fields = dict(const)
                for f, vals in cols.items():
                    fields[f] = col_dec[f](vals[i])
                try:
                    store.patch(kind, key, fields, when=when_dec)
                except (KeyError, PreconditionFailed):
                    pass
                self._obj_enc.pop((kind, key), None)
            self._dirty_kinds.add(kind)
        elif op == "delete":
            store.delete(kind, rec["key"])
            self._obj_enc.pop((kind, rec["key"]), None)
            self._dirty_kinds.add(kind)
        elif op == "segment":
            from volcano_tpu_torch.store.segment import DecisionSegment

            seg = DecisionSegment.from_wire(rec)
            store.apply_segment_lazy(seg, stamp=rec.get("stamp"))
            # the snapshot-seeded encodings of the touched keys are stale
            for k in seg.bind_keys:
                self._obj_enc.pop(("Pod", k), None)
            for k in seg.evict_keys:
                self._obj_enc.pop(("Pod", k), None)
            self._dirty_kinds.update(("Pod", "Event"))

    def _saver_loop(self) -> None:
        interval = max(self.save_interval, 0.05)
        while not self._saver_stop.wait(interval):
            try:
                self.flush_state()
            except (OSError, ValueError):
                # a flush racing kill() or a transient IO failure: the next
                # interval retries; the saver must not die
                continue

    def flush_state(self, force: bool = False) -> None:
        """Persist the store if dirty: only the kinds dirtied since the last
        flush are encoded (under the server lock); the file is written
        outside it.  With the WAL it is a checkpoint: the log rotates in
        the same critical section, and the segments below the new floor
        go once the snapshot's rename is durable.  ``force`` writes even
        with nothing dirty (recovery's floor stamp)."""
        if self.state_path is None or self._killed:
            return
        with self._flush_lock:
            with self.lock:
                # writes that bypassed the handlers dirty their kinds here
                self._pump_log()
                if not self._dirty_kinds and not force:
                    return
                floor = self.wal.rotate() if self.wal is not None else None
                enc_of = self._enc_of
                for kind in self._dirty_kinds:
                    items = self.store.list(kind)  # materializes lazy rows
                    if items:
                        self._enc_cache[kind] = [enc_of(kind, o.meta.key) or encode(o)
                                                 for o in items]
                    else:
                        self._enc_cache.pop(kind, None)
                self._dirty_kinds.clear()
                payload = {"seq": self.seq, "rv": self.store._rv,
                           "store_uid": self.store.uid, "kinds": dict(self._enc_cache)}
                if floor is not None:
                    payload["wal_floor"] = floor
            # a crash at any instant leaves the old snapshot or the new one
            tmp = f"{self.state_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.state_path)
            if floor is not None:
                from volcano_tpu_torch.store.wal import fsync_dir

                fsync_dir(os.path.dirname(os.path.abspath(self.state_path)))
                self.wal.drop_below(floor)
        if timeseries.RECORDER is not None:
            timeseries.record("store", log_seq=self.seq, log_rows=self._log_rows,
                              wal=self.wal.stats() if self.wal is not None else None)

    def _stage_enc_hint(self, kind: str, obj, wire: Optional[dict]) -> None:
        """Stage the request's wire dict as the object's encoding for the
        coming pump (under the server lock, after the store verb)."""
        if not wire:
            return
        self._enc_hints[(kind, obj.meta.key)] = self._restamped_enc(obj, wire)

    @staticmethod
    def _restamped_enc(obj, wire: Optional[dict]) -> Dict[str, Any]:
        """The post-verb encoding of ``obj``: the request's wire dict with
        the server-stamped meta fields laid over, or a fresh encode."""
        if not wire:
            return encode(obj)
        enc = dict(wire)
        meta = dict(enc.get("meta") or {})
        meta["resource_version"] = obj.meta.resource_version
        meta["creation_timestamp"] = obj.meta.creation_timestamp
        meta["uid"] = obj.meta.uid
        enc["meta"] = meta
        return enc

    def _encode_event_obj(self, kind: str, ev) -> tuple:
        """(encoded object, encoded old) of a store event through the
        per-object cache.  A copy-on-write patch event (``ev.fields``) lays
        its delta on the cached encoding, path hops shallow-copied, instead
        of encoding the whole object again; the cached entry before the
        patch is the event's ``old``."""
        key = ev.obj.meta.key
        ck = (kind, key)
        cache = self._obj_enc
        if ev.type.value == "Deleted":
            self._enc_of(kind, key)  # resolve the lazy half first
            enc = cache.pop(ck, None)
            if enc is None:
                enc = encode(ev.obj)
            return enc, None
        if ev.fields is not None:
            enc_old = self._enc_of(kind, key)
            if enc_old is not None:
                try:
                    enc = dict(enc_old)
                    meta = dict(enc["meta"])
                    meta["resource_version"] = ev.obj.meta.resource_version
                    enc["meta"] = meta
                    for k, v in ev.fields.items():
                        parts = k.split(".")
                        cur = enc
                        for p in parts[:-1]:
                            child = dict(cur[p])
                            cur[p] = child
                            cur = child
                        cur[parts[-1]] = encode(v)
                except (KeyError, TypeError):
                    # the cached encoding lacks a hop (a hand-built client
                    # dict without an optional subtree): encode anew
                    pass
                else:
                    cache[ck] = enc
                    return enc, enc_old
        hint = self._enc_hints.pop(ck, None)
        if hint is not None:
            enc_old = self._enc_of(kind, key)
            cache[ck] = hint
            return hint, enc_old
        enc = encode(ev.obj)
        self._enc_pending.pop(ck, None)  # a full encode supersedes the lazy half
        cache[ck] = enc
        return enc, encode(ev.old) if ev.old is not None else None

    def _pump_log(self) -> None:
        """Drain the store's watch queues into the ordered log.  A
        partitioned server tags each entry with its object's namespace
        shard (``/watch?shard=`` serves by it; the wire never carries it)."""
        moved = False
        sharded = self.shards > 1
        for kind, q in self._queues.items():
            while q:
                ev = q.popleft()
                self._dirty_kinds.add(kind)
                self.seq += 1
                self._log_rows += 1
                enc_obj, enc_old = self._encode_event_obj(kind, ev)
                entry = {"seq": self.seq, "kind": kind, "type": ev.type.value,
                         "object": enc_obj, "old": enc_old}
                if sharded:
                    entry["shard"] = shard_of_key(ev.obj.meta.key, self.shards)
                self.log.append(entry)
                self._note_watermark(entry.get("shard", 0), self.seq)
                moved = True
        self._trim_log()
        # an unconsumed hint (a no-op write, no event) must not describe a
        # later mutation of its key
        if self._enc_hints:
            self._enc_hints.clear()
        if moved:
            self.cond.notify_all()

    def watch_since(self, since: int, kinds, timeout: float,
                    shard: Optional[int] = None) -> Dict[str, Any]:
        """The log rows after ``since`` of ``kinds`` (all when empty),
        waiting up to ``timeout`` seconds for one; ``relist`` when the cursor
        fell off the buffer or comes from before a restart.  ``shard`` (a
        partitioned server) serves that shard's entries and the untagged
        ones: a shard's watcher expands only its own shard's blocks."""
        deadline = time.monotonic() + timeout
        strip = self.shards > 1
        with self.lock:
            if since < self.seq - self._log_rows or since > self.seq:
                return {"events": None, "next": self.seq, "relist": True}
            while True:
                log = self.log
                # entries' seqs (a block's is its last row's) increase:
                # binary-search the first entry past the cursor
                lo, hi = 0, len(log)
                while lo < hi:
                    mid = (lo + hi) // 2
                    if log[mid]["seq"] > since:
                        hi = mid
                    else:
                        lo = mid + 1
                evs = []
                for e in log[lo:]:
                    # an untagged entry reaches every shard's watcher
                    if shard is not None and e.get("shard", shard) != shard:
                        continue
                    if kinds and e["kind"] not in kinds:
                        continue
                    blk = e.get("block")
                    if blk is None:
                        evs.append({k: v for k, v in e.items() if k != "shard"}
                                   if strip else e)
                        continue
                    # a columnar block: only the rows past the cursor
                    # expand (memoized on the block, shared by watchers)
                    n = e["n"]
                    first_seq = e["seq"] - n + 1
                    skip = since - first_seq + 1 if since >= first_seq else 0
                    start = e["start"]
                    evs.extend(blk.wire_rows(start + skip, start + n))
                if evs or timeout <= 0:
                    return {"events": evs, "next": self.seq}
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"events": [], "next": self.seq}
                self.cond.wait(remaining)

    # -- lifecycle ------------------------------------------------------------------

    def start(self) -> "StoreServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        self._saver_stop.set()
        if self._saver is not None:
            self._saver.join(timeout=5)
        self.flush_state()
        if self.wal is not None:
            # the tail is fsynced even when the flush above found nothing
            # dirty: every acknowledged record stays durable
            self.wal.sync_close()

    def kill(self) -> None:
        """Die like SIGKILL: stop serving and drop everything in memory with
        no final flush, no saver drain and no WAL fsync.  The next boot on
        the same paths recovers the last snapshot and the synced WAL tail."""
        self._killed = True
        self._saver_stop.set()
        # a flush already past the _killed guard lands before a successor
        # boots on these paths
        with self._flush_lock:
            pass
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join(timeout=5)
        self.httpd.server_close()
        if self.wal is not None:
            self.wal.kill()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()


def serve_in_child(url_q, state: str = "", wal: bool = False,
                   save_interval: float = 0.25, shards: int = 1) -> None:
    """A ``multiprocessing`` target (the spawn context): an apiserver on a
    free port of 127.0.0.1, no default queue, its URL put on ``url_q``;
    serves until terminated (SIGTERM flushes) or killed."""
    run_apiserver(state=state, wal=wal, save_interval=save_interval, shards=shards,
                  default_queue=False,
                  announce=lambda line, **_: url_q.put(line.rsplit(" ", 1)[-1]))


def run_apiserver(port: int = 0, host: str = "127.0.0.1", state: str = "", wal: bool = False,
                  save_interval: float = 0.25, shards: int = 1, default_queue: bool = True,
                  announce=print) -> None:
    """Serve until SIGTERM, then stop: the saver joins, the state file is
    flushed and the WAL tail fsynced.  ``state`` names the state file;
    ``wal`` arms the write-ahead log beside it (``<state>.wal/``, a
    subdirectory a shard when ``shards`` > 1); ``shards`` partitions the
    decision bus."""
    import signal
    import sys

    trace.set_component("apiserver")
    srv = StoreServer(host=host, port=port, state_path=state or None, wal=wal,
                      save_interval=save_interval, shards=shards)
    if default_queue and srv.store.get("Queue", "/default") is None:
        from volcano_tpu_torch.api.objects import Metadata, Queue

        srv.store.create("Queue", Queue(meta=Metadata(name="default", namespace="")))
    announce(f"apiserver listening on {srv.url}", flush=True)
    # SIGTERM -> SystemExit on the serving thread (httpd.shutdown() from a
    # signal handler would deadlock against serve_forever)
    signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
    try:
        srv.serve_forever()
    finally:
        # a second SIGTERM must not abort the flush that makes the
        # shutdown graceful (SIGKILL still works: the WAL recovers it)
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        srv.stop()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m volcano_tpu_torch.store.server",
                                 description="the port's apiserver")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0, help="0 picks a free port")
    ap.add_argument("--state", default="", help="the state file (durable objects)")
    ap.add_argument("--wal", action="store_true",
                    help="the write-ahead log beside the state file")
    ap.add_argument("--save-interval", type=float, default=0.25,
                    help="seconds between state flushes; <= 0 flushes before every reply")
    ap.add_argument("--shards", type=int, default=1,
                    help="partition the decision bus into this many namespace shards")
    ap.add_argument("--no-default-queue", action="store_true")
    args = ap.parse_args(argv)
    if args.wal and not args.state:
        ap.error("--wal requires --state")
    if args.shards < 1:
        ap.error("--shards must be at least 1")
    run_apiserver(port=args.port, host=args.host, state=args.state, wal=args.wal,
                  save_interval=args.save_interval, shards=args.shards,
                  default_queue=not args.no_default_queue)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

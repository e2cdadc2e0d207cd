"""Asynchronous, batched side-effect application for the scheduler cache.

The port's copy of ``volcano_tpu/scheduler/apply.py`` without the
namespace-sharded segment ship (ROADMAP item 11b) and the chaos crash point
(item 13).  The reference never serializes its cycle behind API writes:
every bind and eviction runs on its own goroutine with resync on error
(KB/pkg/scheduler/cache/cache.go:393-447).  Here one applier thread drains
a decision queue into the store: a columnar segment (``store/segment.py``)
through ``Store.apply_segment``, everything else through the store's bulk
verb, so that the cycle publishes its decisions and returns.  Over a
``RemoteStore`` a segment whose ship a connection cut left in doubt is
shipped once more: the server dedupes it on its reserved uid block.

Decisions in flight (submitted, not yet confirmed by the store) overlay
the next snapshot: a cycle that starts before the writes land still sees
the pods as bound or releasing, so nothing is scheduled twice.  A failed
write drops its in-flight marker and lands in the cache's ``err_log``;
the next cycle's fresh snapshot retries the task (cache.go:512-533).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from volcano_tpu_torch import events, vtprof
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.store import segment as segmod

#: cap on the Event aggregation index (pod keys churn in a long-lived
#: scheduler; entries past it fall back to fresh Event objects)
EVENT_INDEX_CAP = 4096


class AsyncApplier:
    def __init__(self, cache, batch_max: int = 16384):
        self.cache = cache
        self.store = cache.store
        self.batch_max = batch_max
        self._cv = threading.Condition()
        # ("bind", key, host) | ("evict", key, reason) | ("segment", seg, None)
        # | ("ops", [op, ...], None)
        self._q: deque = deque()
        #: decisions submitted but not confirmed yet, read by snapshot().
        #: _pending counts queued and applying ops per (verb, key): a marker
        #: is dropped only when its LAST pending op finishes, so a
        #: resubmission racing an applying batch keeps its overlay
        self.inflight_binds: Dict[str, str] = {}
        self.inflight_evicts: Dict[str, str] = {}
        self._pending: Dict[Tuple[str, str], int] = {}
        self._applying = 0
        self._stopped = False
        # (involved kind, involved key, reason, message) -> ClusterEvent,
        # the Kubernetes count aggregation (events.record), entered only
        # after the store confirms the create.  A segment's bind Events
        # bypass it: a cycle's binds are unique per (pod, node), so it never
        # fires for them, and walking 100k rows through it would put a
        # per-object loop back on the drain.  Eviction rows keep it: index
        # hits split off the segment onto the count-bump path, fresh rows
        # join it once the segment is confirmed
        self._event_index: OrderedDict = OrderedDict()
        #: cumulative drain seconds by section: a segment's bind, eviction
        #: and Event sections as the store timed them, the other op batches
        #: (PodGroup statuses, enqueue admissions, Event bumps) under pg_s,
        #: and the applier's own share of a segment ship under wire_s
        self.drain_stats: Dict[str, float] = {
            "binds_s": 0.0, "evicts_s": 0.0, "events_s": 0.0, "pg_s": 0.0, "wire_s": 0.0,
        }
        #: the applier thread's exception, if it died (flush raises it)
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="volcano-applier")
        self._thread.start()

    # -- producer side (the scheduling cycle) ----------------------------------

    def submit_bind(self, task_key: str, hostname: str) -> None:
        with self._cv:
            self.inflight_binds[task_key] = hostname
            self.inflight_evicts.pop(task_key, None)
            pk = ("bind", task_key)
            self._pending[pk] = self._pending.get(pk, 0) + 1
            self._q.append(("bind", task_key, hostname))
            self._cv.notify_all()

    def submit_segment(self, seg) -> None:
        """Queue one columnar decision segment, the whole cycle's binds and
        evictions as ONE queue entry, with the overlay markers per key of
        submit_bind / submit_evict."""
        bind_keys = seg.bind_keys
        evict_keys = seg.evict_keys
        with self._cv:
            self.inflight_binds.update(zip(bind_keys, seg.bind_hosts))
            if self.inflight_evicts and bind_keys:
                drop_evict = self.inflight_evicts.pop
                for task_key in bind_keys:
                    drop_evict(task_key, None)
            pending = self._pending
            get = pending.get
            for task_key in bind_keys:
                pk = ("bind", task_key)
                pending[pk] = get(pk, 0) + 1
            if evict_keys:
                self.inflight_evicts.update(zip(evict_keys, seg.evict_reason_strs))
                for task_key in evict_keys:
                    pk = ("evict", task_key)
                    pending[pk] = get(pk, 0) + 1
            self._q.append(("segment", seg, None))
            self._cv.notify_all()

    def submit_ops(self, ops) -> None:
        """Queue pre-built store ops (status patches, condition Events).  No
        overlay markers and no Events of their own; failures land in
        ``err_log`` as "status" under the op's key."""
        with self._cv:
            self._q.append(("ops", ops, None))
            self._cv.notify_all()

    def submit_evict(self, task_key: str, reason: str) -> None:
        with self._cv:
            self.inflight_evicts[task_key] = reason
            pk = ("evict", task_key)
            self._pending[pk] = self._pending.get(pk, 0) + 1
            self._q.append(("evict", task_key, reason))
            self._cv.notify_all()

    def inflight_view(self) -> Tuple[Dict[str, str], Dict[str, str]]:
        """Copies of the in-flight maps.  Callers take them BEFORE listing
        pods: a decision confirmed between the two reads then shows in both
        (harmless), where the other order could miss it in both."""
        with self._cv:
            return dict(self.inflight_binds), dict(self.inflight_evicts)

    def abort_pending(self) -> int:
        """Drop every queued (not yet applying) decision and its overlay
        marker: a deposed leader's stale decisions must not overwrite the
        new leader's.  A batch already in the store write cannot be
        recalled.  Returns the number of entries dropped."""
        with self._cv:
            dropped = len(self._q)
            for verb, key, _ in self._q:
                self._settle(verb, key)
            self._q.clear()
            self._cv.notify_all()
        return dropped

    def _settle(self, verb: str, key) -> None:
        """Drop one queued or applied entry's pending count for its key(s);
        the LAST pending op of a key clears its overlay marker.  Holds
        ``_cv``.  A segment settles every key it carries."""
        if verb == "ops":
            return
        if verb == "segment":
            ops = [("bind", k) for k in key.bind_keys]
            ops += [("evict", k) for k in key.evict_keys]
        else:
            ops = [(verb, key)]
        pending = self._pending
        for v, k in ops:
            left = pending.get((v, k), 1) - 1
            if left <= 0:
                pending.pop((v, k), None)
                if v == "bind":
                    self.inflight_binds.pop(k, None)
                else:
                    self.inflight_evicts.pop(k, None)
            else:
                pending[(v, k)] = left

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted decision has been applied or has
        failed.  Returns False on timeout; raises RuntimeError when the
        applier thread died."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while (self._q or self._applying) and self.error is None:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining)
        if self.error is not None:
            raise RuntimeError("the applier thread died") from self.error
        return True

    def stop(self, flush: bool = True, timeout: float = 30.0) -> None:
        if flush and self.error is None:
            self.flush(timeout)
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    @property
    def pending(self) -> int:
        with self._cv:
            return len(self._q) + self._applying

    # -- consumer side (the applier thread) --------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stopped:
                    self._cv.wait()
                if not self._q and self._stopped:
                    return
                n = min(len(self._q), self.batch_max)
                batch = [self._q.popleft() for _ in range(n)]
                self._applying = n
            t0 = time.perf_counter()
            try:
                self._apply(batch)
                # the write-back cost of one dequeued batch, off the cycle
                metrics.observe("volcano_decision_drain_batch_seconds",
                                time.perf_counter() - t0)
            except BaseException as e:  # noqa: BLE001 — surfaced by flush()
                self.error = e
                raise
            finally:
                with self._cv:
                    self._applying = 0
                    for verb, key, _ in batch:
                        # only a key's LAST pending op clears its marker
                        self._settle(verb, key)
                    self._cv.notify_all()

    def _apply(self, batch) -> None:
        """Apply one drained batch in order: segments whole through the
        store's segment verb, the entries between them through bulk."""
        run: list = []
        for entry in batch:
            if entry[0] == "segment":
                if run:
                    self._apply_ops(run)
                    run = []
                self._apply_segment(entry[1])
            else:
                run.append(entry)
        if run:
            self._apply_ops(run)

    def _apply_segment(self, seg) -> None:
        # eviction rows keep the count aggregation: a repeat of (pod, Evict,
        # message) that hits the index takes the count-bump path after the
        # segment instead of minting a fresh Event
        ship, hit_pairs = seg, []
        if seg.evict_keys and self._event_index:
            hit = self._split_indexed_evicts(seg)
            if hit is not None:
                ship, hit_pairs = hit
        if not ship.empty:
            t0 = time.perf_counter()
            try:
                res = self._ship_segment(ship)
            except Exception as e:  # noqa: BLE001 — store outage: retried next cycle
                for task_key in ship.bind_keys:
                    self.cache._record_err("bind", task_key, e)
                for task_key in ship.evict_keys:
                    self.cache._record_err("evict", task_key, e)
                for task_key, _ in hit_pairs:
                    self.cache._record_err("evict", task_key, e)
                return
            self._settle_segment_result(ship, res, time.perf_counter() - t0)
        if hit_pairs:
            # after the segment, keeping the stream's binds-then-evictions
            # order of a cycle
            self._apply_ops([("evict", k, r) for k, r in hit_pairs])

    def _ship_segment(self, ship):
        """One segment ship, re-shipped once after a connection-level cut (a
        server that died mid-request, a reply cut mid-body): unlike a blind
        mutation retry this is safe, because the store dedupes the segment
        on its reserved uid block (binds and evictions suppress as no-ops,
        Events that landed are skipped).  Anything else, a second cut
        included, goes to the caller's error path and the next cycle
        solves again."""
        try:
            return self.store.apply_segment(ship)
        except Exception as e:  # noqa: BLE001 — classified just below
            from volcano_tpu_torch.store.client import _connection_cut

            if not _connection_cut(e):
                raise
        return self.store.apply_segment(ship)

    def _settle_segment_result(self, ship, res, total: float) -> None:
        """Record a segment's per-row errors, index its fresh Evict Events
        and add the drain attribution (``total``: the ship's wall)."""
        for row, err in res.get("binds") or ():
            self.cache._record_err("bind", ship.bind_keys[row], RuntimeError(err))
        evict_errs = {row for row, _ in res.get("evicts") or ()}
        for row, err in res.get("evicts") or ():
            self.cache._record_err("evict", ship.evict_keys[row], RuntimeError(err))
        self._index_segment_evict_events(ship, evict_errs)
        stats = self.drain_stats
        timings = res.get("timings") or {}
        for k, v in timings.items():
            if k in stats:
                stats[k] += v
        stats["wire_s"] += max(0.0, total - sum(timings.values()))
        prof = vtprof.PROFILER
        if prof is not None:
            # the cumulative drain walls ride the profile
            prof.note_drain(stats)

    def _split_indexed_evicts(self, seg):
        """Split a segment's eviction rows into (the segment to ship,
        [(key, reason)] whose Event already sits in the index); None when
        nothing hits."""
        index = self._event_index
        reasons = seg.evict_reason_strs
        hit_pairs = []
        keep_keys: List[str] = []
        keep_reasons: List[int] = []
        for j, key in enumerate(seg.evict_keys):
            if ("Pod", key, "Evict", events.evicted_message(reasons[j])) in index:
                hit_pairs.append((key, reasons[j]))
            else:
                keep_keys.append(key)
                keep_reasons.append(seg.evict_reasons[j])
        if not hit_pairs:
            return None
        ship = segmod.DecisionSegment(
            seg.bind_keys, seg.bind_nodes, seg.node_table,
            keep_keys, keep_reasons, seg.reason_table, seg.ev_token, seg.ev_start)
        return ship, hit_pairs

    def _index_segment_evict_events(self, ship, evict_errs) -> None:
        """Enter the shipped segment's new Evict Events in the index (named
        from the uid block, as the store named them), so that the next
        occurrence bumps a count.  Error rows never enter."""
        if not ship.evict_keys:
            return
        index = self._event_index
        n_b = len(ship.bind_keys)
        reasons = ship.evict_reason_strs
        for j, key in enumerate(ship.evict_keys):
            if j in evict_errs:
                continue
            msg = events.evicted_message(reasons[j])
            ev = segmod.materialize_event(
                segmod.event_name(ship.ev_token, ship.ev_start + n_b + j),
                key, segmod.EVICT_REASON, msg, events.WARNING, rv=0, stamp=0.0)
            idx_key = ("Pod", key, "Evict", msg)
            index[idx_key] = ev
            index.move_to_end(idx_key)
        while len(index) > EVENT_INDEX_CAP:
            index.popitem(last=False)

    def _apply_ops(self, batch) -> None:
        t0 = time.perf_counter()
        try:
            self._apply_ops_inner(batch)
        finally:
            self.drain_stats["pg_s"] += time.perf_counter() - t0

    def _apply_ops_inner(self, batch) -> None:
        ops = []
        flat = []  # one (verb, key, arg) per op, "ops" entries expanded
        for verb, key, arg in batch:
            if verb == "bind":
                ops.append({"op": "patch", "kind": "Pod", "key": key,
                            "fields": {"node_name": arg}})
                flat.append((verb, key, arg))
            elif verb == "evict":
                ops.append({"op": "patch", "kind": "Pod", "key": key,
                            "fields": {"deleting": True}})
                flat.append((verb, key, arg))
            else:  # a pre-built op list (submit_ops)
                for op in key:
                    ops.append(op)
                    # "status", so that the fast cycle's reconcile re-reads
                    # the PodGroup on either failure path
                    flat.append(("status", op.get("key", op["kind"]), None))
        try:
            results = self.store.bulk(ops)
        except Exception as e:  # noqa: BLE001 — store outage: retried next cycle
            for verb, key, _ in flat:
                self.cache._record_err(verb, key, e)
            return
        ev_ops: List[dict] = []
        ev_meta: List[Tuple[tuple, object, bool]] = []  # (idx_key, ev, is_new)
        for (verb, key, arg), err in zip(flat, results):
            if verb == "status":
                # a conditional op's precondition miss is a benign skip by
                # construction (a concurrent transition)
                if err is not None and not err.startswith("PreconditionFailed"):
                    self.cache._record_err("status", key, RuntimeError(err))
                continue
            if err is not None:
                # a vanished pod or a conflict: the task stays pending in the
                # store and the next cycle's snapshot retries it
                self.cache._record_err(verb, key, RuntimeError(err))
                continue
            if verb == "bind":
                op, meta = events.record_op(
                    self._event_index, "Pod", key, "Scheduled",
                    events.scheduled_message(key, arg), events.NORMAL)
            else:
                op, meta = events.record_op(
                    self._event_index, "Pod", key, "Evict",
                    events.evicted_message(arg), events.WARNING)
            ev_ops.append(op)
            ev_meta.append(meta)
        if not ev_ops:
            return
        try:
            ev_results = self.store.bulk(ev_ops)
        except Exception as e:  # noqa: BLE001
            self.cache._record_err("event", "batch", e)
            return
        for op, (idx_key, ev, is_new), err in zip(ev_ops, ev_meta, ev_results):
            if err is not None:
                # a failed create is not indexed (the next occurrence creates
                # afresh); a failed bump drops the entry, so the next
                # occurrence re-creates rather than patch a missing Event
                self._event_index.pop(idx_key, None)
                self.cache._record_err("event", op.get("key", op["kind"]), RuntimeError(err))
            elif is_new:
                self._event_index[idx_key] = ev
                self._event_index.move_to_end(idx_key)
                while len(self._event_index) > EVENT_INDEX_CAP:
                    self._event_index.popitem(last=False)
            else:
                self._event_index.move_to_end(idx_key)

"""Minimal scheduler cache: the store handle and the bind and evict side
effects.

The port's cut of ``volcano_tpu/scheduler/cache.py``: binds and evictions
apply synchronously through the store's bulk verb (one call each per
cycle), with the same ``bind_log`` / ``evict_log`` / ``err_log``
bookkeeping.  An eviction marks the pod for deletion (``deleting=True``);
the kubelet reaps it.  No async applier, volume binder or eviction events
yet.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

_LOG = logging.getLogger("volcano_tpu_torch.scheduler")


class Evictor:
    """Default evictor: marks pods for deletion, a cycle's victims in one
    store round trip."""

    def __init__(self, store):
        self.store = store

    def evict_bulk(self, evicts: List[Tuple[str, str]]) -> List[Optional[str]]:
        """Per-evict error strings (None on success); a pod already gone
        (the store's "NotFound:" prefix) is a success."""
        results = self.store.bulk([
            {"op": "patch", "kind": "Pod", "key": key, "fields": {"deleting": True}}
            for key, _ in evicts
        ])
        return [None if (err is None or err.startswith("NotFound:")) else err
                for err in results]


class SchedulerCache:
    _ERR_LOG_CAP = 1000

    def __init__(self, store, scheduler_name: str = "volcano-tpu",
                 default_queue: str = "default"):
        self.store = store
        self.scheduler_name = scheduler_name
        self.default_queue = default_queue
        self.evictor = Evictor(store)
        self.bind_log: List[Tuple[str, str]] = []
        self.evict_log: List[Tuple[str, str]] = []  # (pod_key, reason)
        # failed side effects, retried by the next cycle's fresh snapshot
        self.err_log: List[Tuple[str, str, str]] = []  # (op, key, error)

    def _record_err(self, op: str, key: str, err: Exception) -> None:
        _LOG.warning("%s of %s failed (will retry next cycle): %r", op, key, err)
        self.err_log.append((op, key, repr(err)))
        if len(self.err_log) > self._ERR_LOG_CAP:
            del self.err_log[: -self._ERR_LOG_CAP]

    def bind_bulk(self, binds: List[Tuple[str, str]]) -> None:
        """Bind a cycle's placements, (pod_key, node_name) each."""
        if not binds:
            return
        try:
            errs = self.store.bulk([
                {"op": "patch", "kind": "Pod", "key": key, "fields": {"node_name": host}}
                for key, host in binds
            ])
        except Exception as e:  # noqa: BLE001 — store outage: retry next cycle
            for key, _ in binds:
                self._record_err("bind", key, e)
            return
        for (key, host), err in zip(binds, errs):
            if err is not None:
                self._record_err("bind", key, RuntimeError(err))
            else:
                self.bind_log.append((key, host))

    def evict_bulk(self, evicts: List[Tuple[str, str]]) -> None:
        """Evict a cycle's victims, (pod_key, reason) each, through the
        evictor's bulk verb."""
        if not evicts:
            return
        try:
            errs = self.evictor.evict_bulk(evicts)
        except Exception as e:  # noqa: BLE001 — store outage: retry next cycle
            for key, _ in evicts:
                self._record_err("evict", key, e)
            return
        for (key, reason), err in zip(evicts, errs):
            if err is not None:
                self._record_err("evict", key, RuntimeError(err))
            else:
                self.evict_log.append((key, reason))

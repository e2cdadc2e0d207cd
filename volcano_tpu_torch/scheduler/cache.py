"""Minimal scheduler cache: the store handle and the bind side effect.

The port's cut of ``volcano_tpu/scheduler/cache.py``: binds apply
synchronously through the store's bulk verb (one call per cycle), with the
same ``bind_log`` / ``err_log`` bookkeeping.  No async applier, volume
binder or evictor yet.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

_LOG = logging.getLogger("volcano_tpu_torch.scheduler")


class SchedulerCache:
    _ERR_LOG_CAP = 1000

    def __init__(self, store, scheduler_name: str = "volcano-tpu",
                 default_queue: str = "default"):
        self.store = store
        self.scheduler_name = scheduler_name
        self.default_queue = default_queue
        self.bind_log: List[Tuple[str, str]] = []
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

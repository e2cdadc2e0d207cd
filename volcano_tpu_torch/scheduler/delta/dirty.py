"""The dirty set the watch mirror's ingest paths feed.

``DeltaEngine.arm`` installs one ``DirtySet`` as ``mirror.delta_hook``.
Ingest paths that change a pod's aggregate contribution (live, status,
node, job, request, best-effort, dynamic or volume flags) call
:meth:`pod`; events that invalidate the row-keyed aggregates wholesale
(resync, node add or remove, PodGroup removal, queue move) call
:meth:`structural` with a reason, which becomes the full build's
``fallback_reason``.  The hook only records: the engine interprets it at
build time, so an ingest pays one set add.  Only the cycle's thread feeds
it (the watch drain and publish); the async applier's writes come back
through the watch.
"""

from __future__ import annotations

from typing import List, Set


class DirtySet:
    """The pod rows dirtied since the last build, and the structural
    reasons pending since the last full build."""

    def __init__(self) -> None:
        self.pods: Set[int] = set()
        #: ordered, without repeats; non-empty forces the next build full
        self.structural_reasons: List[str] = []

    def pod(self, row: int) -> None:
        self.pods.add(int(row))

    def pods_many(self, rows) -> None:
        """Many rows at once (publish's bind columns)."""
        self.pods.update(int(r) for r in rows)

    def structural(self, reason: str) -> None:
        if reason not in self.structural_reasons:
            self.structural_reasons.append(reason)

    def clear(self) -> None:
        """A full build absorbed everything recorded so far."""
        self.pods.clear()
        self.structural_reasons.clear()

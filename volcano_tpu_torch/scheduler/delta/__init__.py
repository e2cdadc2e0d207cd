"""Incremental scheduling: event-driven micro-cycles of the fast cycle.

The port's copy of ``volcano_tpu/scheduler/delta/``:

* ``dirty``       — the dirty set the watch mirror's ingest paths feed
                    (pod rows, and the structural reasons that force a
                    full build);
* ``incremental`` — row-keyed pod aggregates kept by shadow diff from the
                    dirty set, the one patch of the snapshot's task planes,
                    and the ``snapshot-incremental`` oracle;
* ``admission``   — the token-bucket admission gate and the backlog
                    watermark shedding (the ``Backlogged`` condition);
* ``engine``      — ``DeltaEngine``: micro build or full fallback, with
                    its reason, and the cycle's admission stats.

Host modules only: a micro cycle launches the same kernels as a full one,
at the task bucket the cycle already had.
"""

from volcano_tpu_torch.scheduler.delta.dirty import DirtySet
from volcano_tpu_torch.scheduler.delta.engine import DeltaEngine

__all__ = ["DirtySet", "DeltaEngine"]

"""The node-sharded decision cycle over ``torch.distributed`` (the port of
``volcano_tpu/parallel``): node state split into blocks of rows, one
candidate exchange a round.  See ``parallel/sharded.py``.  The
multi-controller cycle (``volcano_tpu/parallel/multihost.py``) is not
ported yet."""

from volcano_tpu_torch.parallel.sharded import (
    GroupMesh,
    LocalMesh,
    fetch_outputs,
    make_mesh,
    make_sharded_cycle,
    resolve_mesh,
    run_cycle_reference,
)

__all__ = [
    "GroupMesh",
    "LocalMesh",
    "fetch_outputs",
    "make_mesh",
    "make_sharded_cycle",
    "resolve_mesh",
    "run_cycle_reference",
]

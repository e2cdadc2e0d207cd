"""The node-sharded decision cycle over ``torch.distributed`` (the port of
``volcano_tpu/parallel``): node state split into blocks of rows, one
candidate exchange a round (``parallel/sharded.py``, K12a), the victim
solve on node blocks (K12b), and the multi-controller cycle over a
(hosts, nodes) mesh (``parallel/multihost.py``, K13)."""

from volcano_tpu_torch.parallel.sharded import (
    GroupMesh,
    LocalMesh,
    fetch_outputs,
    make_mesh,
    make_sharded_cycle,
    make_sharded_victim_step,
    resolve_mesh,
    run_cycle_reference,
)

__all__ = [
    "GroupMesh",
    "LocalMesh",
    "fetch_outputs",
    "host_bounds",
    "make_host_mesh",
    "make_mesh",
    "make_multihost_cycle",
    "make_sharded_cycle",
    "make_sharded_victim_step",
    "resolve_mesh",
    "run_cycle_reference",
    "run_lockstep",
]

_MULTIHOST = ("host_bounds", "make_host_mesh", "make_multihost_cycle", "run_lockstep")


def __getattr__(name):
    # multihost loads on first use, so that ``python -m
    # volcano_tpu_torch.parallel.multihost`` runs the module only once
    if name in _MULTIHOST:
        from volcano_tpu_torch.parallel import multihost

        return getattr(multihost, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

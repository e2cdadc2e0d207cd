"""Scheduler configuration: actions + tiered plugin options.

The port's copy of ``volcano_tpu/scheduler/conf.py`` without the delta
and checkpoint keys.  ``backend`` selects where the solves run: ``"cuda"``
(the default: the hand-written kernels on the card; raises when no card is
present) or ``"cpu"`` (their plain PyTorch versions).  ``mesh`` splits the
batched solve's node planes into blocks (``parallel/sharded.py``
``resolve_mesh``): ``"off"``, ``"auto"`` (the process group's world size)
or a power-of-two block count.  ``mesh_hosts`` / ``mesh_host_id`` launch the
multi-controller cycle (``parallel/multihost.py``): every host runs the
same global solve and publishes only its owned task block's binds; host 0,
the coordinator, also owns statuses and enqueue admissions.  ``apply_mode``
"async" hands binds and evictions to a background applier thread
(``scheduler/apply.py``), each fast cycle's decisions as ONE columnar
segment (``store/segment.py``); "sync", the default, applies them inline.
The JAX conf's ``columnar_publish`` is not kept: the applier always ships
the segment.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

BACKENDS = ("cuda", "cpu")
APPLY_MODES = ("sync", "async")


@dataclass
class PluginOption:
    """A tier's plugin with its arguments and the callback enable flags the
    fast cycle reads (the reference defaults them all to true)."""

    name: str
    arguments: Dict[str, str] = field(default_factory=dict)
    enabled_job_order: bool = True
    enabled_job_ready: bool = True
    enabled_job_pipelined: bool = True
    enabled_task_order: bool = True
    enabled_preemptable: bool = True
    enabled_reclaimable: bool = True
    enabled_queue_order: bool = True


@dataclass
class Tier:
    plugins: List[PluginOption] = field(default_factory=list)


@dataclass
class SchedulerConf:
    actions: List[str] = field(default_factory=lambda: ["allocate", "backfill"])
    tiers: List[Tier] = field(default_factory=list)
    backend: str = "cuda"
    solve_mode: str = "auto"  # "auto" | "exact" | "batch"
    # "auto": the array-native fast cycle whenever it can express the
    # cycle, the object path otherwise; "off": the object path every cycle
    fast_path: str = "auto"
    # node blocks of the batched solve: "off", "auto" or a power of two.
    # Under an initialised process group the blocks spread over its ranks;
    # otherwise they all sit on this process's device.  Only the batched
    # solve shards (the exact solve stays on one block)
    mesh: str = "off"
    # the multi-controller launch (parallel/multihost.py): the host count
    # and this process's host id; 1 / 0 is the single controller
    mesh_hosts: int = 1
    mesh_host_id: int = 0
    # "async": binds and evictions batch through a background applier
    # thread (the reference's per-bind goroutines, cache.go:393-447), the
    # fast cycle's as one columnar segment; "sync": applied inline,
    # deterministic
    apply_mode: str = "sync"

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Raise ValueError for a host count below 1, a host id outside
        [0, mesh_hosts) or an unknown apply mode (the JAX loader's
        checks)."""
        if self.apply_mode not in APPLY_MODES:
            raise ValueError(f"apply_mode must be one of {APPLY_MODES}, "
                             f"got {self.apply_mode!r}")
        if self.mesh_hosts < 1:
            raise ValueError(f"mesh_hosts must be >= 1, got {self.mesh_hosts}")
        if not 0 <= self.mesh_host_id < self.mesh_hosts:
            raise ValueError(f"mesh_host_id {self.mesh_host_id} outside "
                             f"[0, {self.mesh_hosts})")


def default_conf(backend: str = "cuda") -> SchedulerConf:
    """Parity with defaultSchedulerConf (KB/pkg/scheduler/util.go:31-41)."""
    return SchedulerConf(
        actions=["allocate", "backfill"],
        tiers=[
            Tier(plugins=[PluginOption("priority"), PluginOption("gang")]),
            Tier(plugins=[
                PluginOption("drf"), PluginOption("predicates"),
                PluginOption("proportion"), PluginOption("nodeorder"),
            ]),
        ],
        backend=backend,
    )


def full_conf(backend: str = "cuda") -> SchedulerConf:
    """All five actions and all seven plugins: the reference's deployed
    configuration (installer chart config/kube-batch.conf), reclaim before
    allocate so that freed capacity is claimable in the same cycle."""
    conf = default_conf(backend)
    conf.actions = ["enqueue", "reclaim", "allocate", "backfill", "preempt"]
    conf.tiers[0].plugins.append(PluginOption("conformance"))
    return conf


def get_plugin_arg(args: Dict[str, str], key: str,
                   default: Optional[float] = None) -> Optional[float]:
    """Numeric plugin argument lookup (reference framework/arguments.go)."""
    if key in args:
        try:
            return float(args[key])
        except ValueError:
            return default
    return default

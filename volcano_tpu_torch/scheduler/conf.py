"""Scheduler configuration: actions + tiered plugin options.

The port's copy of ``volcano_tpu/scheduler/conf.py`` without the mesh,
delta and checkpoint keys.  ``backend`` selects where the solves run:
``"cuda"`` (the default: the hand-written kernels on the card; raises when
no card is present) or ``"cpu"`` (their plain PyTorch versions).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

BACKENDS = ("cuda", "cpu")


@dataclass
class PluginOption:
    """A tier's plugin with its arguments and the callback enable flags the
    express cycle reads (the reference defaults them all to true)."""

    name: str
    arguments: Dict[str, str] = field(default_factory=dict)
    enabled_job_order: bool = True
    enabled_job_ready: bool = True
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
    """All seven plugins, with the actions this port runs: enqueue,
    allocate, backfill (reclaim and preempt belong to a later slice)."""
    conf = default_conf(backend)
    conf.actions = ["enqueue", "allocate", "backfill"]
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

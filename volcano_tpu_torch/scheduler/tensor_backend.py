"""Solve policy and device placement for the port's tensor path.

The port's cut of ``volcano_tpu/scheduler/tensor_backend.py``: the
plugin-derived policy flags (tier-ordered job keys, gang readiness,
proportion queue order, task order by priority), the victim veto sets of
preempt and reclaim, the proportion deserved shares (the water-fill
kernel, once per cycle), the node-order and interpod score weights, and
host -> device uploads memoised by array identity.  With a conf mesh
(``parallel/sharded.py``), ``placement_fn`` places the node-axis planes of
a batched solve as this process's blocks of rows.

The fast cycle hands the backend its snapshot (``backend.snapshot =
snap``).  The object path attaches a backend to its session
(``ssn=``): the snapshot is then built from the session on first use
(``build_tensor_snapshot``, through the Scheduler's ``SnapshotCache`` when
it has one) and rebuilt after ``invalidate()``, and ``victim_arrays()``
gives ``victim_step`` its constants and state.  With a cache the backend
uploads through the cache's own ``DeviceUploads`` (its device tier, which
an epoch roll clears), so the class planes and node statics it reuses
across cycles stay on the card; without one it uploads through the
Scheduler's ``DeviceUploads``, which the fast cycle shares.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from volcano_tpu_torch.scheduler.conf import get_plugin_arg
from volcano_tpu_torch.scheduler.snapshot import TensorSnapshot, build_tensor_snapshot

#: above this many placements the object path's allocate applies the
#: solve's decisions in bulk instead of replaying each through the session
BULK_THRESHOLD = 5000
#: above this many pending tasks the batched-rounds solve replaces the
#: exact sequential solve
BATCH_THRESHOLD = 4096

#: plugins the tensor kernels model
TENSORIZABLE = {
    "gang", "priority", "drf", "proportion", "predicates", "nodeorder",
    "conformance",
}


class DeviceUploads:
    """Host -> device copies keyed by the numpy array's identity: an array
    uploaded before is not copied again while it lives (bounded LRU; each
    entry holds its host array, so an id cannot be reused under it)."""

    def __init__(self, device: torch.device, max_entries: int = 64):
        self.device = device
        self._memo: "OrderedDict[int, tuple]" = OrderedDict()
        self._max = max_entries

    def clear(self) -> None:
        self._memo.clear()

    def __call__(self, arr: np.ndarray) -> torch.Tensor:
        hit = self._memo.get(id(arr))
        if hit is not None and hit[0] is arr:
            self._memo.move_to_end(id(arr))
            return hit[1]
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        self._memo[id(arr)] = (arr, t)
        while len(self._memo) > self._max:
            self._memo.popitem(last=False)
        return t


class TensorBackend:
    def __init__(self, tiers, device: torch.device, uploads: DeviceUploads,
                 solve_mode: str = "auto", batch_threshold: int = BATCH_THRESHOLD,
                 ssn=None, mesh=None, snapshot_cache=None):
        self.ssn = ssn
        #: the Scheduler's SnapshotCache (object sessions), or None
        self.snapshot_cache = snapshot_cache
        #: the conf mesh (parallel/sharded.py LocalMesh / GroupMesh) or None
        self.mesh = mesh
        #: the multi-controller launch: this host's id (None: one
        #: controller) and the host count; the fast cycle sets them
        self.mesh_host: Optional[int] = None
        self.mesh_hosts = 1
        self._mesh_memo: Dict[str, tuple] = {}
        self.bulk_threshold = BULK_THRESHOLD
        self.device = device
        self.to_device = uploads
        self.solve_mode = solve_mode
        self.batch_threshold = batch_threshold
        self.nodeorder_args: Dict[str, str] = {}
        self.unsupported = []
        job_key_order = []
        self.gang_job_ready = False
        self.proportion_queue_order = False
        self.task_order_by_priority = False
        self.tiers = tiers
        names = set()
        for tier in tiers:
            for opt in tier.plugins:
                names.add(opt.name)
                if opt.name == "nodeorder":
                    self.nodeorder_args = opt.arguments
                if opt.name not in TENSORIZABLE:
                    self.unsupported.append(opt.name)
                if opt.name in ("priority", "gang", "drf") and opt.enabled_job_order:
                    if opt.name not in job_key_order:
                        job_key_order.append(opt.name)
                if opt.name == "gang" and opt.enabled_job_ready:
                    self.gang_job_ready = True
                if opt.name == "priority" and opt.enabled_task_order:
                    self.task_order_by_priority = True
                if opt.name == "proportion" and opt.enabled_queue_order:
                    self.proportion_queue_order = True
        self.job_key_order = tuple(job_key_order)
        self.enabled = {n: (n in names) for n in TENSORIZABLE}
        self.supported = not self.unsupported
        self._snapshot: Optional[TensorSnapshot] = None
        self._deserved: Optional[torch.Tensor] = None

    @property
    def snapshot(self) -> TensorSnapshot:
        if self._snapshot is None and self.ssn is not None:
            self._snapshot = build_tensor_snapshot(
                self.ssn, nodeaffinity_weight=self.nodeaffinity_weight(),
                task_order_by_priority=self.task_order_by_priority,
                cache=self.snapshot_cache)
        return self._snapshot

    @snapshot.setter
    def snapshot(self, snap: TensorSnapshot) -> None:
        self._snapshot = snap

    def to_device_named(self, arr: np.ndarray, name: str):
        """Host -> device with the conf mesh's placement: a node-axis plane
        (``name`` as in parallel/sharded._SPECS) as the tuple of this
        process's blocks of rows, anything else as ``to_device`` places it.
        A plane whose node rows do not divide into the mesh's blocks raises
        (no silent single-block run).  Placements memoise by field name and
        host-array identity."""
        from volcano_tpu_torch.parallel.sharded import _SPECS, split_rows

        if self.mesh is None or name not in _SPECS:
            return self.to_device(arr)
        hit = self._mesh_memo.get(name)
        if hit is not None and hit[0] is arr:
            return hit[1]
        blocks = split_rows(self.mesh, name, self.to_device(arr))
        self._mesh_memo[name] = (arr, blocks)
        return blocks

    def placement_fn(self, batch_active: bool):
        """The one sharding decision: blocks only when the batched solve
        will consume the arrays (the exact solve's steps stay on one
        block).  The callable has ``to_device_named``'s ``(arr, name)``
        shape."""
        if batch_active and self.mesh is not None:
            return self.to_device_named
        return lambda arr, name: self.to_device(arr)

    def invalidate(self) -> None:
        """Host state changed behind the snapshot: rebuild it on next use.
        The deserved shares stay: proportion freezes them at session open."""
        self._snapshot = None

    def deserved(self) -> torch.Tensor:
        """Proportion water-filling deserved shares [Q, R] on the device,
        computed once per cycle (proportion freezes them at session open)."""
        if self._deserved is None:
            from volcano_tpu_torch.scheduler.kernels import water_fill

            s, dev = self.snapshot, self.to_device
            self._deserved = water_fill(
                dev(s.queue_weight), dev(s.queue_request), dev(s.total),
                dev(s.eps), dev(s.queue_participates),
            )
        return self._deserved

    def victim_sharded(self) -> bool:
        """Whether the victim solves run on the mesh's node blocks (the
        object path's K12b, the fast cycle's K15a-c): under a conf mesh with
        ``solve_mode="batch"`` only, as in the JAX package."""
        return self.mesh is not None and self.solve_mode == "batch"

    def victim_arrays(self):
        """(VictimConsts, VictimState) of the snapshot on the device; the
        state tensors are fresh copies, never views of the host arrays.
        When ``victim_sharded()``, the node planes of both are tuples of this
        process's blocks (``parallel/sharded._VICTIM_SPECS``)."""
        from volcano_tpu_torch.parallel.sharded import split_rows
        from volcano_tpu_torch.scheduler.victim_kernels import VictimConsts, VictimState

        s, dev = self.snapshot, self.to_device
        # the constants' node planes split only under solveMode: batch
        devn = self.placement_fn(self.victim_sharded())
        w_least, w_bal = self.score_weights()
        consts = VictimConsts(
            run_req=dev(s.run_req), run_node=dev(s.run_node), run_job=dev(s.run_job),
            run_prio=dev(s.run_prio), run_rank=dev(s.run_rank),
            run_evictable=dev(s.run_evictable), job_queue=dev(s.job_queue),
            job_min=dev(s.job_min_available), node_alloc=devn(s.node_alloc, "node_alloc"),
            node_max_tasks=devn(s.node_max_tasks, "node_max_tasks"),
            node_valid=devn(s.node_valid, "node_valid"),
            class_mask=devn(s.class_node_mask, "class_mask"),
            class_score=devn(s.class_node_score, "class_score"),
            queue_deserved=self.deserved(), total=dev(s.total), eps=dev(s.eps),
            w_least=w_least, w_balanced=w_bal,
        )
        blocked = self.victim_sharded()

        def fresh(arr, name=None):
            t = torch.from_numpy(np.array(arr)).to(self.device)
            return split_rows(self.mesh, name, t) if blocked and name else t

        state = VictimState(
            run_live=fresh(s.run_valid), idle=fresh(s.node_idle, "idle"),
            releasing=fresh(s.node_releasing, "releasing"), used=fresh(s.node_used, "used"),
            task_count=fresh(s.node_task_count, "task_count"),
            job_alloc=fresh(s.job_alloc_init), job_occupied=fresh(s.job_ready_init),
            queue_alloc=fresh(s.queue_alloc_init),
        )
        return consts, state

    def victim_vetoes(self):
        """Active veto plugin sets for preempt and reclaim: the first tier
        with any enabled plugin that registers the callback decides, and
        the plugins within it intersect (session_plugins.go Preemptable /
        Reclaimable)."""
        preempt_set = reclaim_set = None
        for tier in self.tiers:
            p = {o.name for o in tier.plugins
                 if o.name in ("gang", "drf", "conformance") and o.enabled_preemptable}
            if preempt_set is None and p:
                preempt_set = p
            r = {o.name for o in tier.plugins
                 if o.name in ("gang", "proportion", "conformance") and o.enabled_reclaimable}
            if reclaim_set is None and r:
                reclaim_set = r
        return preempt_set or set(), reclaim_set or set()

    def score_weights(self):
        if not self.enabled["nodeorder"]:
            return 0.0, 0.0
        w_least = get_plugin_arg(self.nodeorder_args, "leastrequested.weight", 1.0)
        w_bal = get_plugin_arg(self.nodeorder_args, "balancedresource.weight", 1.0)
        return float(w_least), float(w_bal)

    def podaffinity_weight(self) -> float:
        """The interpod score weight of the dynamic solve (0 without the
        nodeorder plugin)."""
        if not self.enabled["nodeorder"]:
            return 0.0
        return float(get_plugin_arg(self.nodeorder_args, "podaffinity.weight", 1.0))

    def nodeaffinity_weight(self) -> float:
        if not self.enabled["nodeorder"]:
            return 0.0
        return float(get_plugin_arg(self.nodeorder_args, "nodeaffinity.weight", 1.0))

"""Solve policy and device placement for the port's tensor path.

The port's cut of ``volcano_tpu/scheduler/tensor_backend.py``: the
plugin-derived policy flags (tier-ordered job keys, gang readiness,
proportion queue order, task order by priority), the victim veto sets of
preempt and reclaim, the proportion deserved shares (the water-fill
kernel, once per cycle), the node-order and interpod score weights, and
host -> device uploads memoised by array identity.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from volcano_tpu_torch.scheduler.conf import get_plugin_arg
from volcano_tpu_torch.scheduler.snapshot import TensorSnapshot

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
                 solve_mode: str = "auto", batch_threshold: int = BATCH_THRESHOLD):
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
        self.snapshot: Optional[TensorSnapshot] = None
        self._deserved: Optional[torch.Tensor] = None

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

"""The scheduler: one express cycle per ``run_once``.

The port's cut of ``volcano_tpu/scheduler/scheduler.py``: every cycle runs
the array-native fast cycle (``fastpath/cycle.py``) on the conf's device.
``backend="cuda"`` (the default) runs the hand-written kernels on the card
and raises RuntimeError when no card is present; ``backend="cpu"`` runs
their plain PyTorch versions.  Clusters or confs outside this port's slice
raise NotImplementedError — there is no object-path fallback yet.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from volcano_tpu_torch.scheduler.cache import SchedulerCache
from volcano_tpu_torch.scheduler.conf import BACKENDS, SchedulerConf, full_conf
from volcano_tpu_torch.scheduler.fastpath.cycle import FastCycle
from volcano_tpu_torch.scheduler.tensor_backend import DeviceUploads


def resolve_device(backend: str) -> torch.device:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "backend 'cuda' needs a CUDA device and none is available; "
                "pass backend='cpu' to run the plain PyTorch versions")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class Scheduler:
    def __init__(self, store, conf: Optional[SchedulerConf] = None,
                 scheduler_name: str = "volcano-tpu",
                 default_queue: str = "default"):
        self.conf = conf or full_conf()
        self.device = resolve_device(self.conf.backend)
        self.cache = SchedulerCache(store, scheduler_name=scheduler_name,
                                    default_queue=default_queue)
        self.uploads = DeviceUploads(self.device)
        self.fast_cycle = FastCycle(self)

    def prewarm(self) -> float:
        """Build and load the kernels (on the card), touch the device, and
        sync the watch mirror, so the first cycle pays only watch deltas.
        Returns the seconds it took."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from volcano_tpu_torch import _build

            _build.load()
            torch.ones(1, device=self.device).sum().item()
        self.fast_cycle.sync_mirror()
        return time.perf_counter() - t0

    def run_once(self) -> None:
        self.fast_cycle.try_run()

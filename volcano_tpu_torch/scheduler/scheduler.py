"""The scheduler: one cycle per ``run_once``.

The port's cut of ``volcano_tpu/scheduler/scheduler.py``: every cycle
tries the array-native fast cycle (``fastpath/cycle.py``) first and falls
back to the object path (``run_object_actions``: open a session with a
``TensorBackend`` attached, run the conf's actions in order, close it)
wherever the fast cycle declines, or on every cycle with ``fast_path:
off``.  ``backend="cuda"`` (the default) runs the hand-written kernels on
the card and raises RuntimeError when no card is present;
``backend="cpu"`` runs their plain PyTorch versions.  A conf ``mesh``
resolves to the node blocks every batched solve shards over
(``parallel/sharded.py``).  ``mesh_hosts > 1`` runs the multi-controller
cycle: this process publishes only its owned task block, and a worker
(``mesh_host_id != 0``) skips the cycles its fast cycle declines.  Work the
fast cycle's device passes cannot express (residue jobs, preempt beside
dynamic-predicate jobs) runs in its object sub-cycle,
``run_object_residue``: one session that sees the fast cycle's published
binds, the residue allocate on the vectorized engine
(``scheduler/residue.py``), backfill, and the preempt action.
``apply_mode="async"`` builds the cache with an applier thread: the fast
cycle's decisions reach the store off the cycle, the applier is flushed
before a whole cycle runs on the object path, and ``close()`` stops the
thread.  Every cycle records the scheduler's metrics
(``scheduler/metrics.py``).  Left out: the leader elector that calls
``applier.abort_pending`` (ROADMAP item 9b).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import torch

import volcano_tpu_torch.scheduler.actions  # noqa: F401  (registers actions)
import volcano_tpu_torch.scheduler.plugins  # noqa: F401  (registers plugins)
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.scheduler.cache import SchedulerCache
from volcano_tpu_torch.scheduler.conf import BACKENDS, SchedulerConf, full_conf
from volcano_tpu_torch.scheduler.fastpath.cycle import FastCycle
from volcano_tpu_torch.scheduler.framework import close_session, get_action, open_session
from volcano_tpu_torch.scheduler.tensor_backend import DeviceUploads, TensorBackend

FAST_PATHS = ("auto", "off")

_LOG = logging.getLogger("volcano_tpu_torch.scheduler")


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
        if self.conf.fast_path not in FAST_PATHS:
            raise ValueError(f"fast_path must be one of {FAST_PATHS}, "
                             f"got {self.conf.fast_path!r}")
        self.device = resolve_device(self.conf.backend)
        self.conf.validate()
        # multi-controller launch (parallel/multihost.py): this process
        # solves the global cycle and publishes only its owned task block.
        # Contention passes write victim state outside any one host's block,
        # so preempt and reclaim are refused.  The JAX package also requires
        # backend "tpu" here, to keep out its host and native backends; both
        # of the port's backends ("cuda" and "cpu") are the tensor path, so
        # either is accepted.
        if self.conf.mesh_hosts > 1:
            storm = sorted({"preempt", "reclaim"} & set(self.conf.actions))
            if storm:
                raise ValueError(
                    f"mesh_hosts > 1 forbids actions {storm}: contention passes write "
                    "victim state outside the host's owned task block")
        #: the node blocks every batched solve shards over, or None
        self.mesh = None
        if self.conf.mesh != "off":
            from volcano_tpu_torch.parallel.sharded import resolve_mesh

            self.mesh = resolve_mesh(self.conf.mesh, self.device)
        self.cache = SchedulerCache(store, scheduler_name=scheduler_name,
                                    default_queue=default_queue,
                                    async_apply=self.conf.apply_mode == "async")
        self.uploads = DeviceUploads(self.device)
        self.fast_cycle = FastCycle(self) if self.conf.fast_path != "off" else None
        #: "fast" or "object": the path the last cycle took
        self.last_path = ""
        #: wall seconds of the last object cycle or object sub-cycle:
        #: session_open, each action by name, close_session
        self.object_phases: Dict[str, float] = {}

    def prewarm(self) -> float:
        """Build and load the kernels (on the card), touch the device, and
        sync the watch mirror, so the first cycle pays only watch deltas.
        Returns the seconds it took."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from volcano_tpu_torch import _build

            _build.load()
            torch.ones(1, device=self.device).sum().item()
        if self.fast_cycle is not None:
            self.fast_cycle.sync_mirror()
        return time.perf_counter() - t0

    #: seconds the applier gets to drain before a whole-cycle object
    #: fallback (the JAX scheduler's)
    FALLBACK_FLUSH_TIMEOUT_S = 60.0

    def run_once(self) -> None:
        start = time.perf_counter()
        if self.fast_cycle is not None and self.fast_cycle.try_run():
            self.last_path = "fast"
            metrics.update_e2e_duration(start)
            return
        if self.fast_cycle is not None and not self.fast_cycle.is_coordinator:
            # a mesh-host worker whose fast cycle declined: the object path
            # writes the whole cluster, single-writer work the coordinator
            # takes; the worker's mirror reconciles through the watch
            self.last_path = "mesh-worker-skip"
            return
        if self.fast_cycle is not None and self.cache.applier is not None:
            # earlier fast cycles' decisions (binds, statuses, admissions)
            # must be IN the store before an object session snapshots it
            if not self.cache.applier.flush(timeout=self.FALLBACK_FLUSH_TIMEOUT_S):
                _LOG.warning("the applier did not drain in %.0f s before an object cycle",
                             self.FALLBACK_FLUSH_TIMEOUT_S)
        self.run_object_actions(self.conf.actions)
        self.last_path = "object"
        metrics.update_e2e_duration(start)

    def close(self) -> None:
        """Stop the applier thread (after draining it), if there is one."""
        if self.cache.applier is not None:
            self.cache.applier.stop()

    def _open_object_session(self):
        ssn = open_session(self.cache, self.conf.tiers)
        ssn.tensor_backend = TensorBackend(
            self.conf.tiers, self.device, self.uploads,
            solve_mode=self.conf.solve_mode, ssn=ssn, mesh=self.mesh)
        return ssn

    def run_object_actions(self, names) -> None:
        """One object-path pass: open a session with the tensor backend
        attached, execute ``names`` in order, close."""
        ph = self.object_phases = {}
        t = time.perf_counter()
        ssn = self._open_object_session()
        ph["session_open"] = time.perf_counter() - t
        for name in names:
            action = get_action(name)
            if action is None:
                continue
            t = time.perf_counter()
            action.execute(ssn)
            metrics.update_action_duration(name, t)
            ph[name] = time.perf_counter() - t
        t = time.perf_counter()
        close_session(ssn)
        ph["close_session"] = time.perf_counter() - t

    def run_object_residue(self, residue_keys, run_preempt: bool) -> None:
        """The fast cycle's object sub-cycle: allocate and backfill scoped
        to the residue jobs (by PodGroup key, or by the shadow uid of plain
        pods), then the preempt action if ``run_preempt``, in one session
        that sees the fast cycle's published binds through
        ``cache.cycle_overlay``.  close_session owns the cycle's PodGroup
        status writes.  ``object_phases`` gets the sub-cycle's walls."""
        from volcano_tpu_torch.scheduler.actions.allocate import AllocateAction
        from volcano_tpu_torch.scheduler.actions.backfill import BackfillAction

        ph = self.object_phases = {}
        t = time.perf_counter()
        ssn = self._open_object_session()
        ph["session_open"] = time.perf_counter() - t
        if residue_keys:
            def in_residue(job):
                if job.pod_group is not None:
                    return job.pod_group.meta.key in residue_keys
                # shadow gangs: the session keys them by the same
                # shadow/{ns}/{owner-or-name} uid as the fast mirror
                return job.uid in residue_keys

            if "allocate" in self.conf.actions:
                # the vectorized engine; its share of the sub-cycle is the
                # fast cycle's residue_vec phase
                stats = self.fast_cycle.residue_stats if self.fast_cycle is not None else None
                t = time.perf_counter()
                AllocateAction()._execute_host(ssn, job_filter=in_residue, stats=stats)
                metrics.update_action_duration("allocate", t)
                ph["allocate"] = time.perf_counter() - t
            if "backfill" in self.conf.actions:
                t = time.perf_counter()
                BackfillAction().execute(ssn, job_filter=in_residue)
                metrics.update_action_duration("backfill", t)
                ph["backfill"] = time.perf_counter() - t
        if run_preempt:
            action = get_action("preempt")
            if action is not None:
                t = time.perf_counter()
                action.execute(ssn)
                metrics.update_action_duration("preempt", t)
                ph["preempt"] = time.perf_counter() - t
        t = time.perf_counter()
        close_session(ssn)
        ph["close_session"] = time.perf_counter() - t

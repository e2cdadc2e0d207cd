"""The scheduler: one cycle per ``run_once``.

The port's copy of ``volcano_tpu/scheduler/scheduler.py``: every cycle
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
(``scheduler/metrics.py``), and, while the time-series recorder is armed
(``volcano_tpu_torch/timeseries.py``), one cycle row (``_record_cycle``).
With ``conf.delta == "on"`` the fast cycle runs the incremental engine's
micro-cycles (``scheduler/delta/``).

Both object sessions, the whole-cycle one and the sub-cycle's, build their
tensor snapshot through the Scheduler's ``SnapshotCache``
(``scheduler/snapshot.py``), which keeps the class planes, the node
statics and their uploads across cycles while the node epoch holds.  With
an ``elector`` (``leader.py``) only the lease holder schedules: a standby
cycle drops the decisions its applier still queues from a lost leadership
(``AsyncApplier.abort_pending``) and rebuilds its mirror from the store
(``FastCycle.reset_after_abort``).  ``prewarm`` loads the kernels, touches
the card beside the mirror's first sync (or its restore from
``conf.mirror_checkpoint``), and launches each kernel variant the live
cluster can reach once, its decisions discarded; ``save_mirror_checkpoint``
writes the checkpoint a restarted scheduler restores from.  While the
tracer is armed (``trace.py``) every cycle is a ``scheduler.cycle`` span
(path fast or object) with its actions, plugins, statements and device
solves beneath it, and the sub-cycle a ``scheduler.residue`` span; while
the profiler is armed (``vtprof.py``) every cycle is one profile record
(``begin_cycle`` / ``end_cycle``) and ``prewarm`` ends with the warmup
handshake, deferred to the background warm's end when it has one.  With
``VOLCANO_TPU_PROFILE`` set to a directory, every cycle runs under
``torch.profiler`` and writes ``cycle-NNNNNN/trace.json`` there.  Not
ported: the digest audit tick, which raises the steady-state divergence
crash dump, and the daemon entry (ROADMAP item 11).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import volcano_tpu_torch.scheduler.actions  # noqa: F401  (registers actions)
import volcano_tpu_torch.scheduler.plugins  # noqa: F401  (registers plugins)
from volcano_tpu_torch import timeseries, trace, vtprof
from volcano_tpu_torch.scheduler import kernels, metrics
from volcano_tpu_torch.scheduler.cache import SchedulerCache
from volcano_tpu_torch.scheduler.conf import BACKENDS, SchedulerConf, full_conf, load_conf
from volcano_tpu_torch.scheduler.fastpath.cycle import FastCycle
from volcano_tpu_torch.scheduler.framework import close_session, get_action, open_session
from volcano_tpu_torch.scheduler.snapshot import SnapshotCache
from volcano_tpu_torch.scheduler.tensor_backend import DeviceUploads, TensorBackend

FAST_PATHS = ("auto", "off")

_LOG = logging.getLogger("volcano_tpu_torch.scheduler")


def _session_traces(ssn) -> list:
    """The trace ids the session's gangs carry (PodGroup annotations): the
    cycle span links them, so that one gang's trace reconstructs the cycle
    that scheduled it.  Armed-only; the callers check first."""
    out = set()
    for job in ssn.jobs.values():
        pg = job.pod_group
        if pg is not None:
            tid = pg.meta.annotations.get(trace.TRACE_ID_KEY, "")
            if tid:
                out.add(tid)
    return sorted(out)


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
                 default_queue: str = "default", elector=None):
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
        #: a LeaderElector, or None (this scheduler always leads)
        self.elector = elector
        #: the fast cycle's uploads, and the object sessions' without a cache
        self.uploads = DeviceUploads(self.device)
        #: the object sessions' cross-cycle snapshot cache, or None; its
        #: device tier holds every upload of an object cycle, so it keeps
        #: more entries than the fast cycle's memo
        self.snapshot_cache: Optional[SnapshotCache] = SnapshotCache(
            DeviceUploads(self.device, max_entries=256))
        self.fast_cycle = FastCycle(self) if self.conf.fast_path != "off" else None
        #: "fast", "object", "mesh-worker-skip" or "standby": the last cycle's path
        self.last_path = ""
        #: wall seconds of the last object cycle or object sub-cycle:
        #: session_open, each action by name, close_session
        self.object_phases: Dict[str, float] = {}
        # a cycle and a warm launch never run at once: the kernel wrappers
        # share module-level workspaces keyed by shape, and a background
        # warm runs beside the first cycles (re-entrant: a deferred warm
        # task runs its own tasks)
        self._launch_lock = threading.RLock()
        #: the background part of the last prewarm (a thread), or None
        self.prewarm_background: Optional[threading.Thread] = None
        #: the warm tasks the last prewarm ran, by part: {"critical": [...],
        #: "later": [...]}, each a variant name ("allocate_solve_batch@L1")
        self.prewarm_tasks: Dict[str, List[str]] = {"critical": [], "later": []}
        #: reprs of background warm tasks that failed (the blocking part
        #: raises instead)
        self.prewarm_errors: List[str] = []
        #: the last prewarm's failure to load the kernels or touch the
        #: device, or None
        self.prewarm_device_error: Optional[str] = None
        # the cycle rows' counter and the bind log's length at the last row
        self._cycle_n = 0
        self._bind_log_n = 0
        #: the next VOLCANO_TPU_PROFILE cycle directory's number
        self._profile_cycle = 0

    @classmethod
    def from_conf_yaml(cls, store, text: str, **kw) -> "Scheduler":
        """A Scheduler over ``store`` with the conf of a scheduler-conf YAML
        text (``conf.load_conf`` and its mapping rules)."""
        return cls(store, conf=load_conf(text), **kw)

    def prewarm(self, bucket_levels: int = 1, background: bool = True) -> float:
        """Warm the cycle's device work before the first cycle; returns the
        seconds it blocked.

        The blocking part: the kernel library loaded and the device touched
        (on a thread, beside the mirror's first sync or its restore from
        ``conf.mirror_checkpoint``), then one launch of each kernel variant
        the live cluster can dispatch now: the allocate solve the live task
        bucket selects (exact or batched, on the mesh's blocks under a
        mesh), the dynamic solve when dynamic-expressible jobs are pending,
        and the contention storm solves when the reclaim / preempt
        prechecks find work now.  The rest (the next ``bucket_levels`` task
        buckets, the object path's victim solves, storm solves no live
        state calls for) runs on a background thread joinable as
        ``prewarm_background``, or blocking with ``background=False``.
        Shapes come from the fast cycle's mirror, or from an object session
        where the fast cycle declines.  Every launch's decisions are
        discarded: no session close, no store write.  On the card "warm"
        means the module loaded, the kernels' attributes set and their
        workspaces allocated at the live shapes; there is no compile cache
        to fill (the build directory persists).  A blocking task that fails
        raises; a background one is logged into ``prewarm_errors``.
        Launch counts (``kernels.LAUNCHES``) include the warm launches:
        read them after the prewarm."""
        from volcano_tpu_torch.scheduler.fastpath.snapshot_build import (
            build_fast_snapshot, build_victim_pool,
        )

        self.prewarm_errors = []
        self.prewarm_device_error = None
        t0 = time.perf_counter()

        def touch_device():
            try:
                if self.device.type == "cuda":
                    from volcano_tpu_torch import _build

                    _build.load()
                torch.ones(1, device=self.device).sum().item()
            except Exception as e:  # noqa: BLE001 — surfaces as prewarm_device_error
                self.prewarm_device_error = repr(e)

        toucher = threading.Thread(target=touch_device, daemon=True)
        toucher.start()
        try:
            fc = self.fast_cycle
            snap = aux = backend = None
            if fc is not None:
                fc.sync_mirror()
                if fc.conf_ok() and fc.mirror is not None and fc.mirror.ineligible_reason() is None:
                    snap, aux = build_fast_snapshot(
                        fc.mirror, fc.nodeaffinity_weight,
                        dyn_batch=(self.conf.solve_mode, fc.probe.batch_threshold))
                    if snap is not None and aux.get("partition_unsafe"):
                        # every real cycle takes the object path: warm its shapes
                        snap = aux = None
            if snap is not None:
                if {"preempt", "reclaim"} & set(self.conf.actions):
                    build_victim_pool(fc.mirror, snap, aux)
                backend = TensorBackend(self.conf.tiers, self.device, self.uploads,
                                        solve_mode=self.conf.solve_mode, mesh=self.mesh)
                backend.snapshot = snap
            else:
                aux = None
                ssn = open_session(self.cache, self.conf.tiers)
                backend = self._object_backend(ssn)
                if not backend.supported:
                    return time.perf_counter() - t0
                ssn.tensor_backend = backend
                snap = backend.snapshot
        finally:
            toucher.join()
        critical, later = self._warm_tasks(backend, snap, aux, bucket_levels)
        self.prewarm_tasks = {"critical": [n for n, _ in critical],
                              "later": [n for n, _ in later]}
        self._run_warm_tasks(critical)
        if background and later:
            def bg_warm():
                self._run_warm_tasks(later, True)
                # the background warm's launch shapes are warmup too
                self._warmup_handshake()

            self.prewarm_background = threading.Thread(
                target=bg_warm, daemon=True, name="volcano-prewarm")
            self.prewarm_background.start()
        else:
            self._run_warm_tasks(later)
            self._warmup_handshake()
        return time.perf_counter() - t0

    @staticmethod
    def _warmup_handshake() -> None:
        """The end of warmup for an armed profiler: the launch shapes,
        workspaces and builds so far were expected; the first cycle without
        new ones marks steady state, and any later one is an anomaly."""
        if vtprof.PROFILER is not None:
            vtprof.PROFILER.warmup_handshake()

    def _run_warm_tasks(self, tasks, swallow: bool = False) -> None:
        """Run (name, thunk) warm tasks in order, each under the launch lock
        and ended by a device sync; ``swallow``: log a failure into
        ``prewarm_errors`` and go on (the background part)."""
        for name, task in tasks:
            try:
                with self._launch_lock:
                    task()
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
            except Exception as e:  # noqa: BLE001
                if not swallow:
                    raise
                self.prewarm_errors.append(f"{name}: {e!r}")
                _LOG.warning("background prewarm task %s failed", name, exc_info=True)

    def _warm_tasks(self, backend, snap, aux, bucket_levels: int):
        """(critical, later) lists of (name, thunk): critical is what the
        first cycle can dispatch given the live cluster."""
        from volcano_tpu_torch.scheduler import tensor_actions as TA
        from volcano_tpu_torch.scheduler import victim_kernels as VK
        from volcano_tpu_torch.scheduler.snapshot import _bucket, pad_task_bucket

        solve_mode, thr = backend.solve_mode, backend.batch_threshold
        t_now = snap.task_req.shape[0]
        n_pending = int(snap.task_valid.sum())
        min_bucket = _bucket(1)
        critical, later = [], []

        def exact_reachable(T: int) -> bool:
            if solve_mode != "auto":
                return solve_mode == "exact"
            lo = T // 2 + 1 if T > min_bucket else 0
            return lo <= thr  # some pending count in this bucket takes the exact solve

        def batch_reachable(T: int) -> bool:
            return solve_mode == "batch" or (solve_mode == "auto" and T > thr)

        use_batch_now = TA.use_batch_solve(backend, n_pending)
        for level in range(bucket_levels + 1):
            shaped = snap if level == 0 else pad_task_bucket(snap, t_now << level)
            T = shaped.task_req.shape[0]
            tag = "" if level == 0 else f"@L{level}"
            if exact_reachable(T):
                (critical if level == 0 and not use_batch_now else later).append(
                    ("allocate_solve" + tag,
                     lambda s=shaped: TA.torch_allocate_solve(backend, s, n_pending=0)))
            if batch_reachable(T):
                (critical if level == 0 and use_batch_now else later).append(
                    ("allocate_solve_batch" + tag,
                     lambda s=shaped: TA.torch_allocate_solve(backend, s, n_pending=thr + 1)))

        # the dynamic solve (ports, pod (anti)affinity, volumes): critical
        # when dynamic-expressible jobs are pending now
        dyn_now = bool(aux is not None and aux.get("dyn_expr_job") is not None
                       and aux["dyn_expr_job"].any())
        if dyn_now and self.fast_cycle is not None:
            from volcano_tpu_torch.scheduler.fastpath.snapshot_build import build_dyn_solve_inputs

            fc = self.fast_cycle

            def warm_dyn():
                T = snap.task_req.shape[0]
                dyn = build_dyn_solve_inputs(
                    fc.mirror, snap, aux, fc.nodeaffinity_weight, np.zeros(T, np.int32),
                    np.zeros(T, np.int32), np.zeros(0, np.int64), np.zeros(0, np.int32),
                    snap.job_ready_init)
                if dyn is not None:
                    TA.torch_dynamic_solve(backend, snap, dyn)

            critical.append(("dynamic_solve", warm_dyn))

        # a cluster with dynamic-predicate work runs its contention on the
        # host (the object walk), so no storm kernel would ever launch
        dynamic = snap.has_dynamic_predicates or bool(
            aux and (aux.get("residue_keys") or dyn_now))
        if {"preempt", "reclaim"} & set(self.conf.actions) and not dynamic:
            fc = self.fast_cycle
            contention_now = True
            if aux and fc is not None:
                contention_now = (
                    ("reclaim" in self.conf.actions and fc._reclaim_possible(snap, aux))
                    or ("preempt" in self.conf.actions and fc._preempt_possible(snap, aux)))

            def storm_tasks():
                from volcano_tpu_torch.scheduler.fast_victims import contention_static_args

                static = contention_static_args(self.conf, backend)
                consts, state = backend.victim_arrays()
                mesh = backend.mesh if backend.victim_sharded() else None
                dev = backend.device
                T, J = snap.task_req.shape[0], snap.job_queue.shape[0]
                Q = snap.queue_alloc_init.shape[0]

                def up(arr):
                    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

                task_req, task_class = up(snap.task_req), up(snap.task_class)
                job_start = up(snap.job_start.astype(np.int32))
                job_ntasks = up(snap.job_ntasks.astype(np.int32))
                job_prio = up(snap.job_priority.astype(np.int32))
                zj32, zjb = up(np.zeros(J, np.int32)), up(np.zeros(J, bool))
                sfx = "" if mesh is None else "_sharded"

                def solve(name, *args, **kw):
                    fn = getattr(VK, name + sfx)
                    return fn(*args, **kw) if mesh is None else fn(*args, mesh, **kw)

                def step(mode, **kw):
                    t_req = up(snap.task_req[0])
                    if mesh is None:
                        return VK.victim_step(consts, state, t_req, 0, 0, 0, mode=mode, **kw)
                    return VK.victim_step_sharded(consts, state, t_req, 0, 0, 0, mesh,
                                                  mode=mode, **kw)

                storm, fallback = [], []
                kw_p, kw_r = static["kw_preempt"], static["kw_reclaim"]
                if "preempt" in self.conf.actions:
                    for mode in ("queue", "job"):
                        # the object path's per-preemptor solve: never the
                        # first fast cycle's
                        fallback.append((f"victim_step{sfx}:{mode}",
                                         lambda m=mode: step(m, use_prop=False, **kw_p)))
                    policy = dict(job_key_order=static["job_key_order"],
                                  gang_pipelined=static["gang_pipelined"], **kw_p)
                    storm.append(("preempt_solve" + sfx, lambda: solve(
                        "preempt_solve", consts, state, task_req, task_class,
                        up(np.zeros(T, bool)), job_start, job_ntasks, job_prio, zjb, zj32, 0,
                        up(np.zeros(Q, np.int32)), 0, zj32, **policy)))
                    if self.conf.solve_mode != "exact":
                        # solveMode exact never dispatches the rounds
                        storm.append(("preempt_rounds" + sfx, lambda: solve(
                            "preempt_rounds", consts, state, task_req, task_class,
                            up(np.zeros(T, np.int32)), zj32, zj32, job_prio, zjb, zj32,
                            **policy)))
                if "reclaim" in self.conf.actions:
                    fallback.append((f"victim_step{sfx}:reclaim",
                                     lambda: step("reclaim", use_drf=False, **kw_r)))
                    storm.append(("reclaim_solve" + sfx, lambda: solve(
                        "reclaim_solve", consts, state, task_req, task_class, job_start,
                        job_prio, zjb, up(np.zeros(Q, bool)), zj32,
                        has_proportion=static["has_proportion"],
                        job_key_order=static["job_key_order"], **kw_r)))
                return storm, fallback

            if contention_now:
                storm, fallback = storm_tasks()
                critical.extend(storm)
                later.extend(fallback)
            else:
                def deferred():
                    # even the storm solves' uploads wait for the later part;
                    # its failures raise unless it runs in the background
                    storm, fallback = storm_tasks()
                    self.prewarm_tasks["later"] += [n for n, _ in storm + fallback]
                    self._run_warm_tasks(
                        storm + fallback,
                        swallow=threading.current_thread() is self.prewarm_background)

                later.append(("contention", deferred))
        return critical, later

    def save_mirror_checkpoint(self) -> bool:
        """Write the fast cycle's mirror to ``conf.mirror_checkpoint`` so
        that a restarted scheduler restores it instead of listing the
        cluster.  Skipped (False) while the applier holds decisions: the
        mirror's optimistic rows are not in the store yet.  The mirror
        first drains its watch, so that the rows carry the resource
        versions of the writes that landed since the last cycle (the JAX
        scheduler saves without the drain, and a restore then re-reads
        every pod the last cycle bound)."""
        fc = self.fast_cycle
        path = self.conf.mirror_checkpoint
        if fc is None or fc.mirror is None or not path:
            return False
        if self.cache.applier is not None and self.cache.applier.pending:
            return False
        with self._launch_lock:
            fc.mirror.drain()
            fc.mirror.save_checkpoint(path)
        return True

    #: seconds the applier gets to drain before a whole-cycle object
    #: fallback (the JAX scheduler's)
    FALLBACK_FLUSH_TIMEOUT_S = 60.0

    def run_once(self) -> None:
        if self.elector is not None and not self.elector.try_acquire():
            self._stand_by()
            return
        with self._launch_lock:
            profile_dir = os.environ.get("VOLCANO_TPU_PROFILE")
            if profile_dir:
                self._run_profiled(profile_dir)
            else:
                self._run_once_inner()
            # a cycle whose shares no consumer checked still raises here
            kernels.water_fill_check()

    def _run_profiled(self, profile_dir: str) -> None:
        """One cycle under ``torch.profiler`` (host activity, and the card's
        kernels under a ``cuda`` backend), its Chrome trace written to a
        directory of its own, ``cycle-NNNNNN/trace.json`` under
        ``profile_dir``, so that cycles in the same second never clobber
        each other."""
        from torch.profiler import ProfilerActivity, profile

        cycle_dir = os.path.join(profile_dir, f"cycle-{self._profile_cycle:06d}")
        self._profile_cycle += 1
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            self._run_once_inner()
        os.makedirs(cycle_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(cycle_dir, "trace.json"))

    def _stand_by(self) -> None:
        """A standby (or deposed) scheduler's cycle: only the lease holder
        schedules, and the decisions still queued from a lost leadership
        must not land on top of the new leader's."""
        self.last_path = "standby"
        if self.cache.applier is None:
            return
        dropped = self.cache.applier.abort_pending()
        if dropped:
            _LOG.warning("dropped %d queued decisions on leadership loss", dropped)
            if self.fast_cycle is not None:
                # the mirror recorded those decisions optimistically
                self.fast_cycle.reset_after_abort()

    def _run_once_inner(self) -> None:
        start = time.perf_counter()
        prof = vtprof.PROFILER
        if prof is not None:
            # the profiler's cycle scope (disarmed, the cycle pays this
            # one attribute check)
            prof.begin_cycle()
        fc = self.fast_cycle
        if fc is not None:
            with trace.span("scheduler.cycle", path="fast") as cyc:
                ran = fc.try_run()
                if trace.TRACER is not None:
                    self._annotate_fast_cycle(cyc, ran)
            if ran:
                self.last_path = "fast"
                metrics.update_e2e_duration(start)
                if prof is not None:
                    prof.end_cycle(time.perf_counter() - start, dict(fc.phases or {}), "fast",
                                   mirror=fc.mirror)
                if timeseries.RECORDER is not None:
                    self._record_cycle(start, "fast")
                return
        if fc is not None and not fc.is_coordinator:
            # a mesh-host worker whose fast cycle declined: the object path
            # writes the whole cluster, single-writer work the coordinator
            # takes; the worker's mirror reconciles through the watch
            self.last_path = "mesh-worker-skip"
            if prof is not None:
                prof.end_cycle(time.perf_counter() - start, {}, "mesh-worker-skip")
            return
        if fc is not None and self.cache.applier is not None:
            # earlier fast cycles' decisions (binds, statuses, admissions)
            # must be IN the store before an object session snapshots it
            if not self.cache.applier.flush(timeout=self.FALLBACK_FLUSH_TIMEOUT_S):
                _LOG.warning("the applier did not drain in %.0f s before an object cycle",
                             self.FALLBACK_FLUSH_TIMEOUT_S)
        self.run_object_actions(self.conf.actions)
        self.last_path = "object"
        metrics.update_e2e_duration(start)
        if prof is not None:
            prof.end_cycle(time.perf_counter() - start, {}, "object")
        if timeseries.RECORDER is not None:
            self._record_cycle(start, "object")

    def _annotate_fast_cycle(self, cyc, ran: bool) -> None:
        """Armed-only: the fast cycle's phases, its residue classes and the
        traces of the gangs it served, on its ``scheduler.cycle`` span."""
        fc = self.fast_cycle
        cyc.annotate(completed=ran,
                     **{f"phase.{k}": round(v, 6) for k, v in (fc.phases or {}).items()})
        reasons = fc.last_residue_reasons
        if reasons:
            # which gangs took the slow class and why: the span-side twin
            # of volcano_residue_tasks_total
            cyc.annotate(residue_jobs=len(reasons),
                         residue_classes=",".join(sorted(set(reasons.values()))))
        if ran:
            # the mirror keeps arrays, not annotations: read the PodGroups
            try:
                cyc.link(*sorted(tid for tid in (
                    pg.meta.annotations.get(trace.TRACE_ID_KEY, "")
                    for pg in self.cache.store.list("PodGroup")) if tid))
            except Exception as e:  # noqa: BLE001 — forensics never breaks a cycle
                cyc.annotate(link_error=repr(e))

    def _record_cycle(self, start: float, path: str) -> None:
        """One ``kind="cycle"`` time-series row; the callers check
        ``timeseries.RECORDER`` first.  The recorder adds no phase: it
        observes the cycle and never reshapes it.  With the profiler armed
        the row carries the cycle's ``host_s``, ``device_s`` (dispatch +
        wait) and ``transfer_s``, and on a multi-controller run the
        per-host solve walls ``mesh_hosts``."""
        fields: dict = {"dur_s": round(time.perf_counter() - start, 6),
                        "path": path, "cycle": self._cycle_n}
        self._cycle_n += 1
        fc = self.fast_cycle
        # both paths append to the bind log, so its watermark moves every
        # row: an object cycle after fast ones counts only its own binds
        n_binds = len(self.cache.bind_log)
        if path == "fast" and fc is not None:
            fields["phases"] = {k: round(v, 6) for k, v in (fc.phases or {}).items()}
            fields.update(fc.last_cycle_stats)
        else:
            fields["binds"] = n_binds - self._bind_log_n
        self._bind_log_n = n_binds
        applier = self.cache.applier
        if applier is not None:
            # the decisions published and not yet written back
            fields["drain_pending"] = applier.pending
        prof = vtprof.PROFILER
        if prof is not None and prof.cycles:
            # this cycle's device / host split (end_cycle ran just before)
            seg = prof.cycles[-1].get("seg") or {}
            fields["host_s"] = seg.get("host", 0.0)
            fields["device_s"] = round(seg.get("dispatch", 0.0) + seg.get("wait", 0.0), 6)
            fields["transfer_s"] = seg.get("transfer", 0.0)
        if prof is not None and prof.hosts:
            fields["mesh_hosts"] = {h: {k: round(v, 6) for k, v in row.items()}
                                    for h, row in prof.hosts.items()}
        timeseries.record("cycle", **fields)

    def close(self) -> None:
        """Join the background prewarm, then stop the applier thread (after
        draining it), if there is one."""
        if self.prewarm_background is not None:
            self.prewarm_background.join()
            self.prewarm_background = None
        if self.cache.applier is not None:
            self.cache.applier.stop()

    def _object_backend(self, ssn) -> TensorBackend:
        """An object session's tensor backend: through the snapshot cache
        and its device tier when the Scheduler has one."""
        cache = self.snapshot_cache
        uploads = cache.uploads if cache is not None else self.uploads
        return TensorBackend(self.conf.tiers, self.device, uploads,
                             solve_mode=self.conf.solve_mode, ssn=ssn, mesh=self.mesh,
                             snapshot_cache=cache)

    def _open_object_session(self):
        ssn = open_session(self.cache, self.conf.tiers)
        ssn.tensor_backend = self._object_backend(ssn)
        return ssn

    def run_object_actions(self, names) -> None:
        """One object-path pass: open a session with the tensor backend
        attached, execute ``names`` in order, close."""
        with trace.span("scheduler.cycle", path="object") as cyc:
            ph = self.object_phases = {}
            t = time.perf_counter()
            ssn = self._open_object_session()
            ph["session_open"] = time.perf_counter() - t
            if trace.TRACER is not None:
                # the cycle serves every gang at once: link each traced one
                cyc.link(*_session_traces(ssn))
            for name in names:
                action = get_action(name)
                if action is None:
                    continue
                t = time.perf_counter()
                with trace.span("action", action=name):
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
        with trace.span("scheduler.residue") as sub:
            self._run_object_residue(sub, residue_keys, run_preempt)

    def _run_object_residue(self, sub, residue_keys, run_preempt: bool) -> None:
        from volcano_tpu_torch.scheduler.actions.allocate import AllocateAction
        from volcano_tpu_torch.scheduler.actions.backfill import BackfillAction

        ph = self.object_phases = {}
        t = time.perf_counter()
        ssn = self._open_object_session()
        ph["session_open"] = time.perf_counter() - t
        if trace.TRACER is not None:
            sub.link(*_session_traces(ssn))
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
                with trace.span("action", action="allocate", residue=True):
                    AllocateAction()._execute_host(ssn, job_filter=in_residue, stats=stats)
                metrics.update_action_duration("allocate", t)
                ph["allocate"] = time.perf_counter() - t
            if "backfill" in self.conf.actions:
                t = time.perf_counter()
                with trace.span("action", action="backfill", residue=True):
                    BackfillAction().execute(ssn, job_filter=in_residue)
                metrics.update_action_duration("backfill", t)
                ph["backfill"] = time.perf_counter() - t
        if run_preempt:
            action = get_action("preempt")
            if action is not None:
                t = time.perf_counter()
                with trace.span("action", action="preempt"):
                    action.execute(ssn)
                metrics.update_action_duration("preempt", t)
                ph["preempt"] = time.perf_counter() - t
        t = time.perf_counter()
        close_session(ssn)
        ph["close_session"] = time.perf_counter() - t

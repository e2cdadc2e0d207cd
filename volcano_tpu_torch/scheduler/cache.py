"""Scheduler cache: the store handle, the object snapshot, the bind,
evict and status side effects and the volume binder.

The port's cut of ``volcano_tpu/scheduler/cache.py``: ``snapshot()``
builds the object path's ``ClusterInfo`` (shadow gangs for plain pods
included, their minimum set by a PodDisruptionBudget where one names their
controller).  Binds and evictions apply synchronously by default, per task
(``bind``, ``evict``) or through the store's bulk verb (``bind_bulk``,
``evict_bulk``, the fast cycle's), each success recording a Scheduled or
Evict Event (``events.py``; a failed Event write lands in ``err_log`` as
"event").  With ``async_apply`` they go to an ``AsyncApplier`` thread
(``scheduler/apply.py``) instead: per task from ``bind`` / ``evict``, and
a fast cycle's whole publish as one columnar segment
(``publish_segment``); ``snapshot()`` overlays the decisions still in
flight.  ``bind_log`` / ``evict_log`` record decisions (at publish time
under the applier), ``err_log`` failed writes, retried by the next cycle's
fresh snapshot.  An eviction marks the pod for deletion (``deleting=True``);
the kubelet reaps it.  ``VolumeBinder`` assumes and commits a pod's
claims, as the reference's binder does; it takes the pod itself where the
JAX binder takes a ``TaskInfo``.  ``cycle_overlay`` holds the fast cycle's
published binds while its object sub-cycle runs, and ``snapshot()`` folds
them in too.  While the tracer is armed every bind decision records a
``scheduler.bind`` span in its gang's trace and the pod's first-seen-to-bind
latency (``_trace_bind``).  Left out: the Binder / Evictor seams for custom
binders (ROADMAP item 13).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

from volcano_tpu_torch import events, trace
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.api.objects import POD_GROUP_KEY, Metadata, PersistentVolume, Pod
from volcano_tpu_torch.api.resource import parse_quantity
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.scheduler.model import ClusterInfo, JobInfo, NodeInfo, QueueInfo, TaskInfo

_LOG = logging.getLogger("volcano_tpu_torch.scheduler")


class Evictor:
    """Default evictor: marks pods for deletion, a cycle's victims in one
    store round trip."""

    def __init__(self, store):
        self.store = store

    def evict_bulk(self, evicts: List[Tuple[str, str]]) -> List[Optional[str]]:
        """Per-evict error strings (None on success); a pod already gone
        (the store's "NotFound:" prefix) is a success."""
        results = self.store.bulk([
            {"op": "patch", "kind": "Pod", "key": key, "fields": {"deleting": True}}
            for key, _ in evicts
        ])
        return [None if (err is None or err.startswith("NotFound:")) else err
                for err in results]


class VolumeBindingError(Exception):
    """No PV satisfies a claim mounted by the pod on the chosen node."""


class VolumeBinder:
    """WaitForFirstConsumer volume binding through the scheduler.

    Claim resolution per pod volume:
      * bound claim (``volume_name`` set): the PV's node affinity must match
        the candidate node;
      * pending claim of a *static* class (a ``StorageClass`` with empty
        ``provisioner``, or a class that has pre-created PVs): an Available
        PV of the class, large enough and reachable from the candidate
        node, is *assumed* at allocate time and committed at bind time;
      * pending claim of a dynamic class: always fits, a PV is provisioned
        at bind time.

    Assumptions are session-scoped: ``clear_session`` drops them, so gangs
    that never became ready release their volumes."""

    def __init__(self, store):
        self.store = store
        # pvc_key -> assumed pv_name ("" = dynamic, provision at bind); one
        # assumption per CLAIM, shared by every pod mounting it
        self._claim_assumed: Dict[str, str] = {}
        self._assumed_pvs: Dict[str, str] = {}  # pv_name -> pvc_key
        # session caches (cleared by clear_session): a pod's claim list and
        # a class's staticness do not change within a cycle
        self._claims_cache: Dict[str, List[str]] = {}
        self._static_cache: Dict[str, bool] = {}
        self._qty_cache: Dict[str, float] = {}
        # PVC objects and the PV list, fetched once a session;
        # bind_volumes invalidates both
        self._pvc_obj_cache: Dict[str, object] = {}
        self._pv_list_cache: Optional[List] = None
        self._pv_by_name: Dict[str, object] = {}

    # -- resolution helpers --------------------------------------------------

    def _pending_claims(self, pod) -> List:
        keys = self._claims_cache.get(pod.meta.key)
        if keys is None:
            keys = []
            for name in pod.volumes:
                key = f"{pod.meta.namespace}/{name}"
                if self.store.get("PVC", key) is not None:
                    keys.append(key)
            self._claims_cache[pod.meta.key] = keys
        out = []
        for key in keys:
            pvc = self._pvc_obj_cache.get(key)
            if pvc is None:
                pvc = self.store.get("PVC", key)
                if pvc is not None:
                    self._pvc_obj_cache[key] = pvc
            if pvc is not None:
                out.append(pvc)
        return out

    def _pvs(self) -> List:
        if self._pv_list_cache is None:
            self._pv_list_cache = list(self.store.items("PV"))
            self._pv_by_name = {pv.meta.name: pv for pv in self._pv_list_cache}
        return self._pv_list_cache

    def _pv(self, name: str):
        self._pvs()
        return self._pv_by_name.get(name)

    def _is_static_class(self, class_name: str) -> bool:
        cached = self._static_cache.get(class_name)
        if cached is not None:
            return cached
        sc = self.store.get("StorageClass", f"/{class_name}")
        if sc is not None:
            static = not sc.provisioner
        else:
            # no StorageClass object: static iff pre-created PVs carry it
            # (any phase); PVs provisioned at bind never count
            static = any(pv.storage_class == class_name and not pv.provisioned
                         for pv in self._pvs())
        self._static_cache[class_name] = static
        return static

    def _qty(self, s: str) -> float:
        v = self._qty_cache.get(s)
        if v is None:
            v = self._qty_cache[s] = parse_quantity("memory", s)
        return v

    @staticmethod
    def _affinity_matches(pv, node_labels: Dict[str, str]) -> bool:
        return all(node_labels.get(k) == v for k, v in pv.node_affinity.items())

    def _find_pv(self, pvc, node_labels: Dict[str, str]):
        """Smallest Available un-assumed PV fitting the claim on this node."""
        want = self._qty(pvc.size) if pvc.size else 0.0
        best, best_cap = None, None
        for pv in self._pvs():
            if pv.claim_ref or pv.meta.name in self._assumed_pvs:
                continue
            if pv.storage_class != pvc.storage_class:
                continue
            if not self._affinity_matches(pv, node_labels):
                continue
            cap = self._qty(pv.capacity) if pv.capacity else float("inf")
            if cap < want:
                continue
            if best is None or cap < best_cap:
                best, best_cap = pv, cap
        return best

    def _resolve_claim(self, pvc, labels) -> Tuple[Optional[str], Optional[str]]:
        """(reason, assumption) for one claim on a node with these labels.
        ``reason`` is set when the claim cannot land there; ``assumption`` is
        the PV name to assume, "" to provision at bind, or None when the
        claim is already bound or assumed."""
        assumed = self._claim_assumed.get(pvc.meta.key)
        if pvc.volume_name or assumed:
            reason = self._reachable(pvc.volume_name or assumed, labels)
            if reason is not None:
                return f"{reason} (claim {pvc.meta.name})", None
            return None, None
        if self._is_static_class(pvc.storage_class):
            pv = self._find_pv(pvc, labels)
            if pv is None:
                return (f"no available volume for claim {pvc.meta.name} "
                        f"(class {pvc.storage_class!r})", None)
            return None, pv.meta.name
        return None, ""  # dynamic: provision at bind

    def _reachable(self, pv_name: str, labels) -> Optional[str]:
        pv = self._pv(pv_name)
        if pv is None:
            # a bound or assumed PV deleted from the store: unschedulable
            # everywhere
            return f"volume {pv_name} not found"
        if pv.node_affinity and not self._affinity_matches(pv, labels):
            return f"volume {pv_name} not reachable"
        return None

    # -- the predicate face --------------------------------------------------

    def volume_fit(self, pod, node_labels: Dict[str, str]) -> Optional[str]:
        """Reason the pod's volumes cannot land on a node with these
        labels, or None (node-free wording, so fit errors aggregate one
        histogram entry per volume)."""
        for pvc in self._pending_claims(pod):
            reason, _ = self._resolve_claim(pvc, node_labels)
            if reason is not None:
                return reason
        return None

    def task_constrains_nodes(self, pod) -> bool:
        """Whether volume state can veto nodes for this pod: a bound claim
        on a node-pinned PV, or a pending claim of a static class."""
        for pvc in self._pending_claims(pod):
            if pvc.volume_name:
                pv = self._pv(pvc.volume_name)
                if pv is not None and pv.node_affinity:
                    return True
            elif self._is_static_class(pvc.storage_class):
                return True
        return False

    # -- allocate / bind -----------------------------------------------------

    def allocate_volumes(self, pod, hostname: str) -> None:
        """Assume a PV for each of the pod's pending claims on ``hostname``;
        raises VolumeBindingError (rolling back this call's assumptions)
        when a claim cannot land there."""
        node = self.store.get("Node", f"/{hostname}")
        labels = node.labels if node is not None else {}
        created: List[str] = []
        try:
            for pvc in self._pending_claims(pod):
                key = pvc.meta.key
                reason, assumption = self._resolve_claim(pvc, labels)
                if reason is not None:
                    raise VolumeBindingError(f"{reason} from {hostname}")
                if assumption is None:
                    continue  # already bound, or assumed by a sibling
                self._claim_assumed[key] = assumption
                if assumption:
                    self._assumed_pvs[assumption] = key
                created.append(key)
        except VolumeBindingError:
            for key in created:
                pv_name = self._claim_assumed.pop(key, "")
                if pv_name:
                    self._assumed_pvs.pop(pv_name, None)
            raise

    def bind_volumes(self, pod) -> None:
        """Commit the pod's assumed claims: a static PV takes the claim, a
        dynamic claim gets a new PV; the PVC becomes Bound."""
        for pvc in self._pending_claims(pod):
            key = pvc.meta.key
            if key not in self._claim_assumed:
                continue  # committed by a sibling, or already bound
            pv_name = self._claim_assumed.pop(key)
            if not pv_name:
                # dynamic provisioning: a network PV named by the claim's uid
                pv_name = f"pv-{pvc.meta.uid}"
                if self.store.get("PV", f"/{pv_name}") is None:
                    self.store.create("PV", PersistentVolume(
                        meta=Metadata(name=pv_name, namespace=""), capacity=pvc.size,
                        storage_class=pvc.storage_class, claim_ref=key, provisioned=True))
            else:
                pv = self.store.get("PV", f"/{pv_name}")
                if pv is None:
                    # the assumed PV vanished between allocate and bind:
                    # fail the bind rather than bind the claim to nothing
                    self._assumed_pvs.pop(pv_name, None)
                    raise VolumeBindingError(
                        f"assumed volume {pv_name} for claim {key} vanished before bind")
                pv.claim_ref = key
                self.store.update("PV", pv)
                self._assumed_pvs.pop(pv_name, None)
            pvc.volume_name = pv_name
            pvc.phase = "Bound"
            self.store.update("PVC", pvc)
            self._pvc_obj_cache[key] = pvc
            self._pv_list_cache = None  # a PV was created or changed
            self._pv_by_name = {}

    def clear_session(self) -> None:
        self._claim_assumed.clear()
        self._assumed_pvs.clear()
        self._claims_cache.clear()
        self._static_cache.clear()
        self._pvc_obj_cache.clear()
        self._pv_list_cache = None
        self._pv_by_name = {}


class SchedulerCache:
    _ERR_LOG_CAP = 1000

    def __init__(self, store, scheduler_name: str = "volcano-tpu",
                 default_queue: str = "default", async_apply: bool = False):
        self.store = store
        self.scheduler_name = scheduler_name
        self.default_queue = default_queue
        self.evictor = Evictor(store)
        self.volume_binder = VolumeBinder(store)
        # async decision application (the reference's per-bind goroutines,
        # cache.go:393-447): binds and evictions queue to a background
        # applier; snapshot() overlays the decisions in flight.  Off by
        # default: library use and the tests rely on synchronous visibility
        self.applier = None
        if async_apply:
            from volcano_tpu_torch.scheduler.apply import AsyncApplier

            self.applier = AsyncApplier(self)
        # binds the fast cycle published this cycle (pod key -> node): the
        # object sub-cycle's snapshot folds them in, so it sees the express
        # placements whatever the bind seam wrote to the store.  Set and
        # cleared (try/finally) by FastCycle.try_run around the sub-cycle
        self.cycle_overlay: Dict[str, str] = {}
        self.bind_log: List[Tuple[str, str]] = []
        self.evict_log: List[Tuple[str, str]] = []  # (pod_key, reason)
        # failed side effects, retried by the next cycle's fresh snapshot
        self.err_log: List[Tuple[str, str, str]] = []  # (op, key, error)

    def _record_err(self, op: str, key: str, err: Exception) -> None:
        _LOG.warning("%s of %s failed (will retry next cycle): %r", op, key, err)
        self.err_log.append((op, key, repr(err)))
        if len(self.err_log) > self._ERR_LOG_CAP:
            del self.err_log[: -self._ERR_LOG_CAP]

    # -- snapshot --------------------------------------------------------------

    def snapshot(self) -> ClusterInfo:
        """The object path's view of the store: queues, nodes, a JobInfo per
        PodGroup (in resource-version order; groups whose queue is missing
        are dropped with their pods) and per shadow gang of plain pods,
        each pod of this scheduler as a TaskInfo on its job and node."""
        cluster = ClusterInfo()
        for queue in self.store.items("Queue"):
            qi = QueueInfo(queue)
            cluster.queues[qi.uid] = qi
        for node in self.store.items("Node"):
            cluster.nodes[node.meta.name] = NodeInfo(node)

        default_priority = 0
        priority_classes: Dict[str, int] = {}
        for pc in self.store.items("PriorityClass"):
            priority_classes[pc.meta.name] = pc.value
            if pc.global_default:
                default_priority = pc.value

        order = 0
        pg_by_key: Dict[str, str] = {}
        dropped_pg_uids = set()
        for pg in sorted(self.store.items("PodGroup"), key=lambda p: p.meta.resource_version):
            pg_by_key[pg.meta.key] = pg.meta.uid
            ji = JobInfo(pg.meta.uid, pg)
            ji.creation_order = order
            order += 1
            if not pg.queue:
                ji.queue = self.default_queue
            if ji.queue not in cluster.queues:
                dropped_pg_uids.add(pg.meta.uid)
                continue
            ji.priority = priority_classes.get(pg.priority_class_name, default_priority)
            cluster.jobs[ji.uid] = ji

        # budgets before pods: a budget creates (or configures) the shadow
        # gang of its controller's pods (setPDB): MinAvailable from the
        # budget, name from the PDB, default queue
        for pdb in self.store.items("PodDisruptionBudget"):
            if pdb.meta.owner is None:
                continue  # a budget without a controller configures nothing
            uid = f"shadow/{pdb.meta.namespace}/{pdb.meta.owner[1]}"
            if uid not in cluster.jobs:
                shadow = JobInfo(uid, None)
                shadow.namespace = pdb.meta.namespace
                shadow.queue = self.default_queue
                shadow.creation_order = order
                order += 1
                cluster.jobs[uid] = shadow
            cluster.jobs[uid].name = pdb.meta.name
            cluster.jobs[uid].min_available = pdb.min_available

        # decisions in flight: a bind or eviction published but not yet
        # confirmed by the store must not look schedulable or evictable
        # again.  The marker copies come BEFORE the pod list: a decision
        # confirmed in between shows in both (harmless), where the other
        # order could miss it in both
        inflight_binds: Dict[str, str] = {}
        inflight_evicts: Dict[str, str] = {}
        if self.applier is not None:
            inflight_binds, inflight_evicts = self.applier.inflight_view()
        if self.cycle_overlay:
            merged = dict(self.cycle_overlay)
            merged.update(inflight_binds)
            inflight_binds = merged
        for pod in self.store.items("Pod"):
            if pod.spec.scheduler_name != self.scheduler_name:
                continue
            task = TaskInfo(pod)
            if inflight_binds or inflight_evicts:
                # the overlay reads the task, never the pod again: the
                # applier may land the write between TaskInfo's reads and
                # these (the JAX cache re-reads the pod, and a bind landing
                # in between leaves the task pending)
                host = inflight_binds.get(task.key)
                if host and not task.node_name and task.status in (
                        TaskStatus.PENDING, TaskStatus.BOUND):
                    task.node_name = host
                    task.status = TaskStatus.BOUND
                if task.key in inflight_evicts and task.status in (
                        TaskStatus.RUNNING, TaskStatus.BOUND):
                    task.status = TaskStatus.RELEASING
            if task.priority == 0 and task.priority_class:
                task.priority = priority_classes.get(task.priority_class, default_priority)
            job_uid = self._job_uid_for(pod, pg_by_key)
            if job_uid in dropped_pg_uids:
                continue
            if job_uid not in cluster.jobs:
                # shadow PodGroup for plain pods, MinMember 1
                shadow = JobInfo(job_uid, None)
                shadow.namespace = pod.meta.namespace
                shadow.name = job_uid
                shadow.queue = self.default_queue
                shadow.min_available = 1
                shadow.creation_order = order
                order += 1
                cluster.jobs[job_uid] = shadow
            cluster.jobs[job_uid].add_task(task)
            if task.node_name and task.node_name in cluster.nodes:
                cluster.nodes[task.node_name].add_task(task)
        return cluster

    @staticmethod
    def _job_uid_for(pod: Pod, pg_by_key: Dict[str, str]) -> str:
        group = pod.meta.annotations.get(POD_GROUP_KEY, "")
        if group:
            key = f"{pod.meta.namespace}/{group}"
            if key in pg_by_key:
                return pg_by_key[key]
            return f"shadow/{key}"
        owner = pod.meta.owner
        if owner:
            return f"shadow/{pod.meta.namespace}/{owner[1]}"
        return f"shadow/{pod.meta.namespace}/{pod.meta.name}"

    # -- side effects ------------------------------------------------------------

    def _record_event(self, key: str, reason: str, message: str,
                      type_: str = events.NORMAL) -> None:
        """A Scheduled or Evict Event for a side effect that succeeded; a
        failed Event write must not unwind the cycle."""
        try:
            events.record(self.store, "Pod", key, reason, message, type=type_)
        except Exception as e:  # noqa: BLE001 — side-effect boundary
            self._record_err("event", key, e)

    def _trace_bind(self, key: str, hostname: str, pod=None, published: bool = False) -> None:
        """Armed-only forensics at the bind decision: a zero-duration
        ``scheduler.bind`` span joining the pod's gang trace (the
        ``volcano.sh/trace-id`` annotation), and the reference's
        first-seen-to-bind latency series from the pod's
        ``creation_timestamp``.  ``published=True`` marks the applier's
        paths, where the span records the decision at publish time (the
        store write may still fail and retry).  Callers check
        ``trace.TRACER is not None`` first; the bulk paths pay one store
        read a bind while armed."""
        if pod is None:
            try:
                pod = self.store.get("Pod", key)
            except Exception:  # noqa: BLE001 — forensics never breaks a bind
                pod = None
        if pod is None:
            return
        created = pod.meta.creation_timestamp
        if created:
            # a wall-clock read: the start edge is an epoch stamp another
            # process may have written, so no monotonic clock shares it
            metrics.update_pod_e2e_latency((time.time() - created) * 1e3)
        tid = pod.meta.annotations.get(trace.TRACE_ID_KEY, "")
        if tid:
            # a marker span at the decision instant, in the gang's trace
            attrs = {"task": key, "node": hostname}
            if published:
                attrs["published"] = True
            with trace.span("scheduler.bind", trace_id=tid, **attrs):
                pass

    def bind(self, task: TaskInfo, hostname: str) -> None:
        """Write one placement (with the applier, publish it); a vanished
        pod or a failed write is retried by the next cycle's fresh
        snapshot."""
        if self.applier is not None:
            self.applier.submit_bind(task.key, hostname)
            self.bind_log.append((task.key, hostname))
            if trace.TRACER is not None:
                self._trace_bind(task.key, hostname, getattr(task, "pod", None), published=True)
            return
        try:
            self.store.patch("Pod", task.key, {"node_name": hostname})
        except Exception as e:  # noqa: BLE001 — side-effect boundary
            self._record_err("bind", task.key, e)
            return
        self.bind_log.append((task.key, hostname))
        if trace.TRACER is not None:
            self._trace_bind(task.key, hostname, getattr(task, "pod", None))
        self._record_event(task.key, "Scheduled", events.scheduled_message(task.key, hostname))

    def evict(self, task: TaskInfo, reason: str) -> None:
        """Mark one pod for deletion (a pod already gone is a success)."""
        if self.applier is not None:
            self.applier.submit_evict(task.key, reason)
            self.evict_log.append((task.key, reason))
            return
        try:
            if self.store.get("Pod", task.key) is not None:
                self.store.patch("Pod", task.key, {"deleting": True})
        except Exception as e:  # noqa: BLE001 — side-effect boundary
            self._record_err("evict", task.key, e)
            return
        self.evict_log.append((task.key, reason))
        self._record_event(task.key, "Evict", events.evicted_message(reason), events.WARNING)

    def update_job_status(self, job: JobInfo) -> None:
        pg = job.pod_group
        if pg is not None and self.store.get("PodGroup", pg.meta.key) is not None:
            self.store.update("PodGroup", pg)

    def bind_bulk(self, binds: List[Tuple[str, str]]) -> None:
        """Bind a cycle's placements, (pod_key, node_name) each, through the
        store's bulk verb (the synchronous mode; the applier takes a
        segment)."""
        if not binds:
            return
        try:
            errs = self.store.bulk([
                {"op": "patch", "kind": "Pod", "key": key, "fields": {"node_name": host}}
                for key, host in binds
            ])
        except Exception as e:  # noqa: BLE001 — store outage: retry next cycle
            for key, _ in binds:
                self._record_err("bind", key, e)
            return
        for (key, host), err in zip(binds, errs):
            if err is not None:
                self._record_err("bind", key, RuntimeError(err))
                continue
            self.bind_log.append((key, host))
            if trace.TRACER is not None:
                self._trace_bind(key, host)
            self._record_event(key, "Scheduled", events.scheduled_message(key, host))

    def publish_segment(self, seg) -> None:
        """Publish a cycle's decisions as ONE columnar segment through the
        applier (the synchronous mode calls bind_bulk / evict_bulk).
        bind_log / evict_log record the decisions at publish time."""
        if seg.empty:
            return
        self.applier.submit_segment(seg)
        self.bind_log.extend(zip(seg.bind_keys, seg.bind_hosts))
        self.evict_log.extend(zip(seg.evict_keys, seg.evict_reason_strs))
        if trace.TRACER is not None:
            for key, hostname in zip(seg.bind_keys, seg.bind_hosts):
                self._trace_bind(key, hostname, published=True)

    def evict_bulk(self, evicts: List[Tuple[str, str]]) -> None:
        """Evict a cycle's victims, (pod_key, reason) each, through the
        evictor's bulk verb (the synchronous mode; the applier takes a
        segment)."""
        if not evicts:
            return
        try:
            errs = self.evictor.evict_bulk(evicts)
        except Exception as e:  # noqa: BLE001 — store outage: retry next cycle
            for key, _ in evicts:
                self._record_err("evict", key, e)
            return
        for (key, reason), err in zip(evicts, errs):
            if err is not None:
                self._record_err("evict", key, RuntimeError(err))
                continue
            self.evict_log.append((key, reason))
            self._record_event(key, "Evict", events.evicted_message(reason), events.WARNING)

    def allocate_volumes(self, pod, hostname: str) -> None:
        self.volume_binder.allocate_volumes(pod, hostname)

    def bind_volumes(self, pod) -> None:
        self.volume_binder.bind_volumes(pod)

    def volume_fit(self, pod, node_labels: Dict[str, str]) -> Optional[str]:
        return self.volume_binder.volume_fit(pod, node_labels)

    def clear_session_volumes(self) -> None:
        self.volume_binder.clear_session()

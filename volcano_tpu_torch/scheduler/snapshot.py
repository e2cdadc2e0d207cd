"""Tensorized cluster snapshot: the dense per-cycle view the solves read.

Counterpart of ``volcano_tpu/scheduler/snapshot.py``: the
``TensorSnapshot`` arrays (numpy, host side; ``tensor_backend`` moves them
to the device), shape bucketing, the static predicate-class helpers (node
selector, required node affinity, taints/tolerations, node conditions,
preferred node-affinity score), and ``build_tensor_snapshot``, which the
object path builds from a session (the victim pool's ``run_*`` fields,
the dynamic-job partition and ``partition_unsafe`` included), and the
cross-cycle ``SnapshotCache`` the Scheduler hands it: per-class predicate
rows, the assembled ``[C, N]`` mask / score and the node statics returned
as the same numpy objects while the node epoch holds, and the uploads of
those objects kept on the device.  The fast cycle builds the same arrays
from its watch mirror (``fastpath/snapshot_build.py``).  Tasks sharing a
(selector, affinity, tolerations, ports) template share one [N] predicate
row, so no [T, N] mask is ever built.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from volcano_tpu_torch.api.objects import Node, Pod, match_expressions
from volcano_tpu_torch.api.resource import MIN_MEMORY, MIN_MILLI_CPU, MIN_SCALAR
from volcano_tpu_torch.api.types import PodGroupPhase, TaskStatus, allocated_status
from volcano_tpu_torch.scheduler.model import NodeInfo, TaskInfo


def _bucket(n: int, minimum: int = 8) -> int:
    """Round up to the next power of two (>= minimum) for shape reuse."""
    size = minimum
    while size < n:
        size *= 2
    return size


@dataclass
class TensorSnapshot:
    """Dense arrays describing one scheduling cycle, padded to bucket sizes
    N/T/J/Q/C with validity masks; R = 2 + interned scalar resources."""

    dims: List[str]
    eps: np.ndarray                    # [R]

    node_names: List[str]
    node_idle: np.ndarray              # [N, R]
    node_releasing: np.ndarray         # [N, R]
    node_used: np.ndarray              # [N, R]
    node_alloc: np.ndarray             # [N, R] allocatable
    node_max_tasks: np.ndarray         # [N] i32 (INT32_MAX if unset)
    node_task_count: np.ndarray        # [N] i32
    node_valid: np.ndarray             # [N] bool

    task_uids: List[str]               # index -> pod key
    task_req: np.ndarray               # [T, R] init_resreq
    task_job: np.ndarray               # [T] i32
    task_class: np.ndarray             # [T] i32 predicate class
    task_valid: np.ndarray             # [T] bool

    job_uids: List[str]
    job_queue: np.ndarray              # [J] i32
    job_min_available: np.ndarray      # [J] i32
    job_priority: np.ndarray           # [J] i32
    job_creation: np.ndarray           # [J] i32
    job_ready_init: np.ndarray         # [J] i32
    job_alloc_init: np.ndarray         # [J, R]
    job_schedulable: np.ndarray        # [J] bool (podgroup phase != Pending)
    job_start: np.ndarray              # [J] i32 offset into task arrays
    job_ntasks: np.ndarray             # [J] i32 pending task count

    queue_names: List[str]
    queue_weight: np.ndarray           # [Q] f32
    queue_alloc_init: np.ndarray       # [Q, R]
    queue_request: np.ndarray          # [Q, R] alloc + pending
    queue_valid: np.ndarray            # [Q] bool
    queue_participates: np.ndarray     # [Q] bool

    class_node_mask: np.ndarray        # [C, N] bool
    class_node_score: np.ndarray       # [C, N] f32 static score (node affinity)

    total: np.ndarray = field(default=None)  # [R] cluster allocatable total

    # object path only: jobs with a pending task whose predicates depend on
    # resident state (host ports, pod (anti)affinity, constraining volumes)
    # are left out of the task arrays and placed by the host afterwards;
    # ``partition_unsafe``: such a job outranks an express job of its queue
    has_dynamic_predicates: bool = False
    dynamic_job_uids: List[str] = field(default_factory=list)
    partition_unsafe: bool = False

    # running tasks: the victim pool of preempt and reclaim, by node in
    # snapshot order, within a node by residence; filled on contended
    # cycles only by fastpath.snapshot_build.build_victim_pool
    run_uids: List[str] = field(default_factory=list)
    run_req: np.ndarray = field(default=None)        # [V, R] resreq
    run_node: np.ndarray = field(default=None)       # [V] i32
    run_job: np.ndarray = field(default=None)        # [V] i32
    run_prio: np.ndarray = field(default=None)       # [V] i32
    run_rank: np.ndarray = field(default=None)       # [V] i32 arrival rank
    run_evictable: np.ndarray = field(default=None)  # [V] bool (conformance)
    run_valid: np.ndarray = field(default=None)      # [V] bool


def pad_task_bucket(snap: TensorSnapshot, new_t: int) -> TensorSnapshot:
    """A copy of ``snap`` with the solve's task arrays padded (invalid rows)
    to ``new_t`` rows: ``Scheduler.prewarm`` launches the allocate solve at
    the next task bucket before the cluster crosses into it."""
    import dataclasses

    def pad(a: np.ndarray) -> np.ndarray:
        extra = new_t - a.shape[0]
        if extra <= 0:
            return a
        return np.concatenate([a, np.zeros((extra,) + a.shape[1:], a.dtype)])

    return dataclasses.replace(snap, task_req=pad(snap.task_req), task_job=pad(snap.task_job),
                               task_class=pad(snap.task_class),
                               task_valid=pad(snap.task_valid))


def _task_class_key(pod: Pod):
    spec = pod.spec
    aff = spec.affinity
    return (
        tuple(sorted(spec.node_selector.items())),
        tuple(tuple(term) for term in (aff.node_terms if aff else ())),
        tuple((w, tuple(term)) for w, term in (aff.preferred_node_terms if aff else ())),
        tuple((t.key, t.operator, t.value, t.effect) for t in spec.tolerations),
        tuple(spec.host_ports),
    )


def node_selector_fits(pod: Pod, node: Node) -> bool:
    """PodMatchNodeSelector: node_selector labels AND required node affinity."""
    spec = pod.spec
    labels = node.labels
    for k, v in spec.node_selector.items():
        if labels.get(k) != v:
            return False
    aff = spec.affinity
    if aff and aff.node_terms:
        if not any(match_expressions(labels, term) for term in aff.node_terms):
            return False
    return True


def taints_tolerated(pod: Pod, node: Node) -> bool:
    """PodToleratesNodeTaints: NoSchedule/NoExecute taints must be tolerated."""
    tolerations = pod.spec.tolerations
    for taint in node.taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return False
    return True


def _static_predicate(pod: Pod, node: Node) -> bool:
    """The node-template-dependent part of the predicate chain: everything
    except resource fit, max-task-count and resident-pod-dependent checks."""
    if not node.ready() or node.unschedulable:
        return False
    for cond in node.conditions:
        if cond.kind in ("MemoryPressure", "DiskPressure", "PIDPressure") and cond.status == "True":
            return False
    return node_selector_fits(pod, node) and taints_tolerated(pod, node)


def task_class_key(task: TaskInfo):
    """``_task_class_key`` of a session task: the residue engine's key of
    its per-class static node masks."""
    return _task_class_key(task.pod)


def static_predicate_task(task: TaskInfo, node: NodeInfo) -> bool:
    """``_static_predicate`` in the session's form (a task on a node's
    info), as the residue engine calls it."""
    return _static_predicate(task.pod, node.node)


def node_affinity_score(pod: Pod, node: Node) -> float:
    """Preferred node-affinity terms' summed weights (nodeorder plugin)."""
    aff = pod.spec.affinity
    if aff is None:
        return 0.0
    score = 0.0
    for weight, term in aff.preferred_node_terms:
        if match_expressions(node.labels, term):
            score += weight
    return score


def _resource_vec(res, dims: List[str], out: np.ndarray) -> None:
    out[0] = res.milli_cpu
    out[1] = res.memory
    for i, name in enumerate(dims[2:], start=2):
        out[i] = res.scalars.get(name, 0.0)


_CRITICAL_CLASSES = ("system-cluster-critical", "system-node-critical")


class SnapshotCache:
    """Cross-cycle snapshot cache of the object path (the JAX
    ``SnapshotCache``).  Three tiers, all dropped when the node epoch rolls
    (the ordered (name, resource_version) of the session's nodes: a
    relabel, a taint, a capacity change, a node added or removed; a bind
    or an eviction changes no Node object and keeps it) or the
    node-affinity weight changes:

    * per-class ``[N]`` predicate mask / score rows, LRU-bounded, which
      save the Python predicate sweep over classes x nodes;
    * the assembled ``[C, N]`` class mask / score and the node statics
      (allocatable, pod cap, validity), returned as the SAME numpy objects
      while unchanged;
    * ``uploads``: device copies memoised by host-array identity
      (``tensor_backend.DeviceUploads``), so the reused objects above are
      not copied to the card again.

    The cached arrays are shared across cycles, so nothing may write them
    in place: the solves take them as read-only inputs, and every writer of
    snapshot arrays (the fast cycle's contention fold, the object
    allocate's bulk apply) writes per-cycle arrays only."""

    def __init__(self, uploads=None, max_class_rows: int = 4096):
        self._epoch = None
        self._weight: Optional[float] = None
        # LRU: the class keys of long-gone jobs must not pin [N] rows
        self._rows: "OrderedDict[object, tuple]" = OrderedDict()
        self._max_rows = max_class_rows
        # (class keys, mask [C, N], score [C, N])
        self._assembled: Optional[Tuple[tuple, np.ndarray, np.ndarray]] = None
        # (dims, allocatable [N, R], max tasks [N], valid [N])
        self._node_static = None
        #: the device tier, or None (the caller uploads as it likes)
        self.uploads = uploads
        #: class rows computed / reused by the last build (the sweep saved)
        self.stats: Dict[str, int] = {}

    @staticmethod
    def node_epoch(nodes) -> tuple:
        return tuple((n.name, n.node.meta.resource_version) for n in nodes)

    def roll_epoch(self, epoch, weight: float) -> None:
        """Drop every tier when ``epoch`` or ``weight`` differs from the
        cached one."""
        if epoch == self._epoch and weight == self._weight:
            return
        self._rows.clear()
        self._assembled = None
        self._node_static = None
        # the host arrays are about to be rebuilt with new identities: the
        # old epoch's uploads must not stay pinned on the card
        if self.uploads is not None:
            self.uploads.clear()
        self._epoch = epoch
        self._weight = weight


def build_tensor_snapshot(ssn, nodeaffinity_weight: float = 1.0,
                          task_order_by_priority: bool = True,
                          cache: Optional[SnapshotCache] = None) -> TensorSnapshot:
    """The dense snapshot of a session's object state (the JAX
    ``build_tensor_snapshot``); sums accumulate in float32 in the same
    order.  With ``cache`` the class rows, the assembled class planes and
    the node statics come from it while the node epoch holds."""
    volume_constrains = ssn.cache.volume_binder.task_constrains_nodes

    # -- resource dims ---------------------------------------------------------
    scalar_names: List[str] = []
    seen = set()

    def note_scalars(res):
        for name in res.scalars:
            if name not in seen:
                seen.add(name)
                scalar_names.append(name)

    for node in ssn.nodes.values():
        note_scalars(node.allocatable)
    for job in ssn.jobs.values():
        for t in job.tasks.values():
            note_scalars(t.resreq)
    dims = ["cpu", "memory", *sorted(scalar_names)]
    R = len(dims)
    eps = np.array([MIN_MILLI_CPU, MIN_MEMORY] + [MIN_SCALAR] * (R - 2), dtype=np.float32)

    # -- nodes -----------------------------------------------------------------
    nodes = list(ssn.nodes.values())
    N = _bucket(max(len(nodes), 1))
    if cache is not None:
        cache.roll_epoch(SnapshotCache.node_epoch(nodes), nodeaffinity_weight)
    node_idle = np.zeros((N, R), np.float32)
    node_rel = np.zeros((N, R), np.float32)
    node_used = np.zeros((N, R), np.float32)
    node_tc = np.zeros((N,), np.int32)
    static = cache._node_static if cache is not None else None
    if static is not None and static[0] == tuple(dims):
        _, node_allocatable, node_max_tasks, node_valid = static
    else:
        node_allocatable = np.zeros((N, R), np.float32)
        node_max_tasks = np.full((N,), np.iinfo(np.int32).max, np.int32)
        node_valid = np.zeros((N,), bool)
        for i, ni in enumerate(nodes):
            _resource_vec(ni.allocatable, dims, node_allocatable[i])
            if ni.allocatable.max_task_num is not None:
                node_max_tasks[i] = ni.allocatable.max_task_num
            node_valid[i] = True
        if cache is not None:
            cache._node_static = (tuple(dims), node_allocatable, node_max_tasks, node_valid)
    for i, ni in enumerate(nodes):
        _resource_vec(ni.idle, dims, node_idle[i])
        _resource_vec(ni.releasing, dims, node_rel[i])
        _resource_vec(ni.used, dims, node_used[i])
        node_tc[i] = len(ni.tasks)

    # -- queues, sorted by uid (queue order ties compare uids) -----------------
    queues = sorted(ssn.queues.values(), key=lambda q: q.uid)
    queue_index = {q.uid: i for i, q in enumerate(queues)}
    Q = _bucket(max(len(queues), 1), minimum=4)
    queue_weight = np.zeros((Q,), np.float32)
    queue_alloc = np.zeros((Q, R), np.float32)
    queue_request = np.zeros((Q, R), np.float32)
    queue_valid = np.zeros((Q,), bool)
    queue_participates = np.zeros((Q,), bool)
    for i, q in enumerate(queues):
        queue_weight[i] = q.weight
        queue_valid[i] = True

    # -- jobs + pending tasks --------------------------------------------------
    jobs = sorted(ssn.jobs.values(), key=lambda j: j.creation_order)
    J = _bucket(max(len(jobs), 1), minimum=4)
    job_queue = np.zeros((J,), np.int32)
    job_min = np.zeros((J,), np.int32)
    job_prio = np.zeros((J,), np.int32)
    job_creation = np.arange(J, dtype=np.int32)
    job_ready_init = np.zeros((J,), np.int32)
    job_alloc_init = np.zeros((J, R), np.float32)
    job_schedulable = np.zeros((J,), bool)
    job_start = np.zeros((J,), np.int32)
    job_ntasks = np.zeros((J,), np.int32)

    task_rows = []
    classes: Dict[object, int] = {}
    class_examples = []
    task_job_list: List[int] = []
    task_class_list: List[int] = []
    dynamic_predicates = False
    dynamic_job_uids: List[str] = []
    queue_max_dynamic_prio: Dict[int, int] = {}
    queue_min_express_prio: Dict[int, int] = {}

    tmp = np.zeros((R,), np.float32)
    for j, job in enumerate(jobs):
        qi = queue_index.get(job.queue)
        job_queue[j] = -1 if qi is None else qi
        if qi is not None:
            queue_participates[qi] = True
        job_min[j] = job.min_available
        job_prio[j] = job.priority
        job_schedulable[j] = not (
            job.pod_group is not None
            and job.pod_group.status.phase == PodGroupPhase.PENDING
        )
        for status, tasks in job.task_status_index.items():
            # pipelined tasks count toward drf/proportion shares, as the
            # plugins' allocate events charged them
            charge = allocated_status(status) or status == TaskStatus.PIPELINED
            ready = allocated_status(status) or status == TaskStatus.SUCCEEDED
            for t in tasks.values():
                if charge:
                    _resource_vec(t.resreq, dims, tmp)
                    job_alloc_init[j] += tmp
                    if qi is not None:
                        queue_alloc[qi] += tmp
                        queue_request[qi] += tmp
                elif status == TaskStatus.PENDING and qi is not None:
                    _resource_vec(t.resreq, dims, tmp)
                    queue_request[qi] += tmp
            if ready:
                job_ready_init[j] += len(tasks)

        # pending non-BestEffort tasks in task order: (priority desc, uid)
        # with the priority plugin's task order, else uid
        pend = [t for t in job.task_status_index.get(TaskStatus.PENDING, {}).values()
                if not t.resreq.is_empty()]
        if task_order_by_priority:
            pend.sort(key=lambda t: (-t.priority, t.uid))
        else:
            pend.sort(key=lambda t: t.uid)

        # partition by job: a job with any resident-state-dependent pending
        # task leaves the task arrays whole
        job_dynamic = False
        for t in pend:
            aff = t.pod.spec.affinity
            if t.pod.spec.host_ports or (aff and (aff.pod_affinity or aff.pod_anti_affinity)):
                job_dynamic = True
                break
            if t.pod.volumes and volume_constrains(t.pod):
                job_dynamic = True
                break
        if job_dynamic and pend:
            dynamic_predicates = True
            dynamic_job_uids.append(job.uid)
            if qi is not None:
                cur = queue_max_dynamic_prio.get(qi)
                if cur is None or job.priority > cur:
                    queue_max_dynamic_prio[qi] = job.priority
            job_start[j] = len(task_rows)
            job_ntasks[j] = 0
            continue
        if pend and qi is not None:
            cur = queue_min_express_prio.get(qi)
            if cur is None or job.priority < cur:
                queue_min_express_prio[qi] = job.priority

        job_start[j] = len(task_rows)
        job_ntasks[j] = len(pend)
        for t in pend:
            key = _task_class_key(t.pod)
            if key not in classes:
                classes[key] = len(classes)
                class_examples.append(t)
            task_rows.append(t)
            task_job_list.append(j)
            task_class_list.append(classes[key])

    T = _bucket(max(len(task_rows), 1))
    task_req = np.zeros((T, R), np.float32)
    task_job = np.zeros((T,), np.int32)
    task_class_arr = np.zeros((T,), np.int32)
    task_valid = np.zeros((T,), bool)
    task_uids = []
    for i, t in enumerate(task_rows):
        _resource_vec(t.init_resreq, dims, task_req[i])
        task_job[i] = task_job_list[i]
        task_class_arr[i] = task_class_list[i]
        task_valid[i] = True
        task_uids.append(t.uid)

    # -- predicate classes: the classes x nodes Python sweep, per class row
    # from the cache while the node epoch holds ---------------------------------
    C = _bucket(max(len(classes), 1), minimum=4)
    class_keys = tuple(classes)  # insertion order is the class index order
    assembled = cache._assembled if cache is not None else None
    if assembled is not None and assembled[0] == class_keys and assembled[1].shape == (C, N):
        class_mask, class_score = assembled[1], assembled[2]
        cache.stats = {"rows_built": 0, "rows_reused": len(class_keys), "assembled": 1}
    else:
        class_mask = np.zeros((C, N), bool)
        class_score = np.zeros((C, N), np.float32)
        rows = cache._rows if cache is not None else {}
        built = 0
        for c, example in enumerate(class_examples):
            key = class_keys[c]
            cached_row = rows.get(key)
            if cached_row is not None:
                class_mask[c, : len(nodes)] = cached_row[0][: len(nodes)]
                class_score[c, : len(nodes)] = cached_row[1][: len(nodes)]
                rows.move_to_end(key)
                continue
            built += 1
            pod = example.pod
            for i, ni in enumerate(nodes):
                ok = _static_predicate(pod, ni.node)
                class_mask[c, i] = ok
                if ok:
                    class_score[c, i] = nodeaffinity_weight * node_affinity_score(pod, ni.node)
            if cache is not None:
                rows[key] = (class_mask[c].copy(), class_score[c].copy())
                while len(rows) > cache._max_rows:
                    rows.popitem(last=False)
        if not class_examples:
            class_mask[:, : len(nodes)] = True
        if cache is not None:
            cache._assembled = (class_keys, class_mask, class_score)
            cache.stats = {"rows_built": built, "rows_reused": len(class_keys) - built,
                           "assembled": 0}

    total = node_allocatable[node_valid].sum(axis=0).astype(np.float32)

    # -- running tasks (victim pool), in node-resident order -------------------
    job_row = {job.uid: j for j, job in enumerate(jobs)}
    run_rows: List[Tuple[object, int, int]] = []
    for i, ni in enumerate(nodes):
        for t in ni.tasks.values():
            if t.status != TaskStatus.RUNNING:
                continue
            j = job_row.get(t.job_uid)
            if j is not None:
                run_rows.append((t, i, j))
    V = _bucket(max(len(run_rows), 1))
    run_req = np.zeros((V, R), np.float32)
    run_node = np.zeros((V,), np.int32)
    run_job = np.zeros((V,), np.int32)
    run_prio = np.zeros((V,), np.int32)
    run_rank = np.zeros((V,), np.int32)
    run_evictable = np.zeros((V,), bool)
    run_valid = np.zeros((V,), bool)
    run_uids: List[str] = []
    uid_rank = {uid: r for r, uid in enumerate(sorted(t.uid for t, _, _ in run_rows))}
    for i, (t, n_idx, j_idx) in enumerate(run_rows):
        _resource_vec(t.resreq, dims, run_req[i])
        run_node[i] = n_idx
        run_job[i] = j_idx
        run_prio[i] = t.priority
        run_rank[i] = uid_rank[t.uid]
        run_evictable[i] = not (t.priority_class in _CRITICAL_CLASSES
                                or t.namespace == "kube-system")
        run_valid[i] = True
        run_uids.append(t.uid)

    return TensorSnapshot(
        dims=dims, eps=eps,
        node_names=[n.name for n in nodes], node_idle=node_idle,
        node_releasing=node_rel, node_used=node_used, node_alloc=node_allocatable,
        node_max_tasks=node_max_tasks, node_task_count=node_tc, node_valid=node_valid,
        task_uids=task_uids, task_req=task_req, task_job=task_job,
        task_class=task_class_arr, task_valid=task_valid,
        job_uids=[j.uid for j in jobs], job_queue=job_queue, job_min_available=job_min,
        job_priority=job_prio, job_creation=job_creation, job_ready_init=job_ready_init,
        job_alloc_init=job_alloc_init, job_schedulable=job_schedulable,
        job_start=job_start, job_ntasks=job_ntasks,
        queue_names=[q.name for q in queues], queue_weight=queue_weight,
        queue_alloc_init=queue_alloc, queue_request=queue_request,
        queue_valid=queue_valid, queue_participates=queue_participates,
        class_node_mask=class_mask, class_node_score=class_score, total=total,
        has_dynamic_predicates=dynamic_predicates, dynamic_job_uids=dynamic_job_uids,
        # a dynamic job above an express job of its queue: device-first
        # placement would invert priority under contention
        partition_unsafe=any(
            queue_max_dynamic_prio[qi] > queue_min_express_prio.get(qi, dp)
            for qi, dp in queue_max_dynamic_prio.items()
        ),
        run_uids=run_uids, run_req=run_req, run_node=run_node, run_job=run_job,
        run_prio=run_prio, run_rank=run_rank, run_evictable=run_evictable,
        run_valid=run_valid,
    )

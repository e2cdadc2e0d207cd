"""Watch-fed array mirror of the store — the fast cycle's state layer.

The port's copy of ``volcano_tpu/scheduler/fastpath/mirror.py``: store
watch events apply to numpy row tables in O(changes), and the snapshot
builder reads the tables vectorized.  Kept: pods, nodes, PodGroups (plus
shadow gangs for group-less pods), queues, priority classes and the lazily
filled per-(predicate class, node) cells.  Left out (later slices):
checkpoints, the digest audit, disruption budgets, port/selector interning
and volume state — pods that need them are only flagged, and
``ineligible_reason`` names them so the cycle can refuse the cluster.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from volcano_tpu_torch.api.objects import POD_GROUP_KEY
from volcano_tpu_torch.api.types import PodGroupPhase, TaskStatus, task_status_of_pod
from volcano_tpu_torch.store.store import EventType

# status codes (i8) — a compressed TaskStatus for the pod table
_PENDING, _BOUND, _RUNNING, _RELEASING, _SUCCEEDED, _FAILED, _OTHER = range(7)

_STATUS_CODE = {
    TaskStatus.PENDING: _PENDING,
    TaskStatus.BOUND: _BOUND,
    TaskStatus.BINDING: _BOUND,
    TaskStatus.ALLOCATED: _BOUND,
    TaskStatus.RUNNING: _RUNNING,
    TaskStatus.RELEASING: _RELEASING,
    TaskStatus.SUCCEEDED: _SUCCEEDED,
    TaskStatus.FAILED: _FAILED,
    TaskStatus.UNKNOWN: _OTHER,
}

#: statuses that count as "allocated" (helpers.go:66-73) and as gang-ready
_ALLOCATED_CODES = (_BOUND, _RUNNING)
_READY_CODES = (_BOUND, _RUNNING, _SUCCEEDED)

_INT32_MAX = np.iinfo(np.int32).max


class _Rows:
    """Grow-only row allocator with key <-> row maps and a free list.
    ``reuse=False`` retires freed rows forever (pods hold node rows)."""

    def __init__(self, reuse: bool = True):
        self.key_row: Dict[str, int] = {}
        self.row_key: List[Optional[str]] = []
        self.free: List[int] = []
        self.reuse = reuse

    def acquire(self, key: str) -> Tuple[int, bool]:
        row = self.key_row.get(key)
        if row is not None:
            return row, False
        if self.reuse and self.free:
            row = self.free.pop()
            self.row_key[row] = key
        else:
            row = len(self.row_key)
            self.row_key.append(key)
        self.key_row[key] = row
        return row, True

    def release(self, key: str) -> Optional[int]:
        row = self.key_row.pop(key, None)
        if row is not None:
            self.row_key[row] = None
            self.free.append(row)
        return row


def _grow(arr: np.ndarray, n: int) -> np.ndarray:
    if n <= arr.shape[0]:
        return arr
    cap = max(64, arr.shape[0])
    while cap < n:
        cap *= 2
    out = np.zeros((cap,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


_POD_COLS = (
    "p_req", "p_resreq", "p_prio", "p_status", "p_node", "p_job",
    "p_best_effort", "p_live", "p_rank", "p_dynamic", "p_has_vol", "p_class",
)
_JOB_COLS = (
    "j_min", "j_queue", "j_prio", "j_phase", "j_rv", "j_min_req", "j_live",
    "j_shadow", "j_members",
)


class ArrayMirror:
    """Incremental array mirror of the store, fed by list + watch."""

    #: class-count backstop (the JAX mirror's cap)
    _MAX_CLASSES = 4096

    def __init__(self, store, scheduler_name: str, default_queue: str):
        self.store = store
        self.scheduler_name = scheduler_name
        self.default_queue = default_queue
        self._watches = [
            (kind, store.watch(kind))
            for kind in ("Pod", "Node", "PodGroup", "Queue", "PriorityClass")
        ]
        self._synced = False
        self._resyncing = False
        self._reset_tables(["cpu", "memory"])

    def _reset_tables(self, dims: List[str]) -> None:
        self.dims = list(dims)
        self._dim_index = {d: i for i, d in enumerate(self.dims)}
        R = len(self.dims)
        self.pods = _Rows()
        self.p_req = np.zeros((0, R), np.float32)       # init_resreq
        self.p_resreq = np.zeros((0, R), np.float32)    # resreq (shares/usage)
        self.p_prio = np.zeros((0,), np.int32)
        self.p_status = np.zeros((0,), np.int8)
        self.p_node = np.zeros((0,), np.int32)          # node row or -1
        self.p_job = np.zeros((0,), np.int32)           # job row or -1
        self.p_best_effort = np.zeros((0,), bool)
        self.p_live = np.zeros((0,), bool)
        self.p_rank = np.zeros((0,), np.int64)          # arrival order
        # resident-state predicates (host ports, pod (anti)affinity) and
        # claim-referencing pods: outside this port's slice
        self.p_dynamic = np.zeros((0,), bool)
        self.p_has_vol = np.zeros((0,), bool)
        self.p_class = np.zeros((0,), np.int32)
        self._next_rank = 0

        self.nodes = _Rows(reuse=False)
        self.n_alloc = np.zeros((0, R), np.float32)
        self.n_max_tasks = np.zeros((0,), np.int32)
        self.n_live = np.zeros((0,), bool)
        self.node_objs: List[Optional[object]] = []
        self._retired_node_rows: Dict[str, List[int]] = {}

        # static predicate classes: pods intern their template key; the
        # (class, node) mask/score cells are computed lazily, and node
        # events invalidate just that node's column
        self.class_ids: Dict[object, int] = {}
        self.class_examples: List[object] = []
        self.class_overflow = False
        self.cls_mask = np.zeros((0, 0), bool)
        self.cls_score = np.zeros((0, 0), np.float32)
        self.cls_valid = np.zeros((0, 0), bool)

        self.jobs = _Rows()  # PodGroups + shadow gangs
        self.j_min = np.zeros((0,), np.int32)
        self.j_queue = np.zeros((0,), np.int32)
        self.j_prio = np.zeros((0,), np.int32)
        self.j_phase = np.zeros((0,), np.int8)
        self.j_rv = np.zeros((0,), np.int64)
        self.j_min_req = np.zeros((0, R), np.float32)
        self.j_live = np.zeros((0,), bool)
        # shadow gangs for group-less pods (cache/util.go:36-60): MinMember
        # 1, default queue, priority 0, always schedulable, no status writes
        self.j_shadow = np.zeros((0,), bool)
        self.j_members = np.zeros((0,), np.int32)
        self._shadow_seq = 0
        self.unlinked_pods: Set[str] = set()
        self._waiting_on_group: Dict[str, Set[str]] = {}
        self._pod_wait_group: Dict[str, str] = {}

        self.queues = _Rows()
        self.q_weight = np.zeros((0,), np.float32)
        self.q_live = np.zeros((0,), bool)

        self.priority_classes: Dict[str, int] = {}
        self.default_priority = 0
        self._phases = list(PodGroupPhase)
        self._phase_idx = {p: i for i, p in enumerate(self._phases)}

    # -- ingest ---------------------------------------------------------------

    def _resync(self, dims: Optional[List[str]] = None) -> None:
        self._reset_tables(dims or ["cpu", "memory"])
        self._resyncing = True
        try:
            self._full_sync()
        finally:
            self._resyncing = False

    def _full_sync(self) -> None:
        for pc in self.store.items("PriorityClass"):
            self._on_priority_class(pc)
        for q in self.store.items("Queue"):
            self._on_queue(q)
        for node in self.store.items("Node"):
            self._on_node(node)
        for pg in self.store.items("PodGroup"):
            self._on_podgroup(pg)
        for pod in self.store.items("Pod"):
            self._on_pod(pod)
        self._synced = True

    def drain(self) -> None:
        """Apply queued watch events; the first call performs the full sync
        (row upserts are idempotent, so events queued meanwhile re-apply)."""
        if not self._synced:
            self._full_sync()
            return
        resync = False
        for kind, q in self._watches:
            while q:
                ev = q.popleft()
                deleted = ev.type == EventType.DELETED
                if kind == "Pod":
                    self._del_pod(ev.obj) if deleted else self._on_pod(ev.obj)
                elif kind == "Node":
                    self._del_node(ev.obj) if deleted else self._on_node(ev.obj)
                elif kind == "PodGroup":
                    self._del_podgroup(ev.obj) if deleted else self._on_podgroup(ev.obj)
                else:
                    # queue / priority-class changes re-wire job and pod rows
                    resync = True
        if resync:
            self._resync()

    def _vec(self, res, out_row: np.ndarray) -> bool:
        """Write a Resource into a row; False on an unknown scalar dim."""
        out_row[0] = res.milli_cpu
        out_row[1] = res.memory
        for name, v in res.scalars.items():
            idx = self._dim_index.get(name)
            if idx is None:
                return False
            out_row[idx] = v
        return True

    def _widen_dims(self, res) -> None:
        names = sorted(set(list(res.scalars) + self.dims[2:]))
        self._resync(dims=["cpu", "memory", *names])

    def _on_priority_class(self, pc) -> None:
        self.priority_classes[pc.meta.name] = pc.value
        if pc.global_default:
            self.default_priority = pc.value

    def _on_queue(self, q) -> None:
        row, _ = self.queues.acquire(q.meta.name)
        self.q_weight = _grow(self.q_weight, row + 1)
        self.q_live = _grow(self.q_live, row + 1)
        self.q_weight[row] = q.weight
        self.q_live[row] = True

    def _on_node(self, node) -> None:
        row, new = self.nodes.acquire(node.meta.name)
        n = row + 1
        self.n_alloc = _grow(self.n_alloc, n)
        self.n_max_tasks = _grow(self.n_max_tasks, n)
        self.n_live = _grow(self.n_live, n)
        if new:
            # a node deleted and re-created takes its resident pods along
            retired = self._retired_node_rows.pop(node.meta.name, None)
            if retired:
                stale = np.isin(self.p_node, np.asarray(retired, np.int32))
                self.p_node[stale & self.p_live] = row
        while len(self.node_objs) < n:
            self.node_objs.append(None)
        self.n_alloc[row] = 0.0
        if not self._vec(node.allocatable, self.n_alloc[row]):
            self._widen_dims(node.allocatable)
            return
        self.n_max_tasks[row] = (
            node.allocatable.max_task_num
            if node.allocatable.max_task_num is not None else _INT32_MAX
        )
        self.node_objs[row] = node
        self.n_live[row] = True
        if self.cls_valid.shape[1] > row:
            self.cls_valid[:, row] = False

    def _del_node(self, node) -> None:
        name = node.meta.name
        row = self.nodes.release(name)
        if row is not None:
            self.n_live[row] = False
            self.node_objs[row] = None
            self._retired_node_rows.setdefault(name, []).append(row)

    def _grow_job_arrays(self, n: int) -> None:
        for col in _JOB_COLS:
            setattr(self, col, _grow(getattr(self, col), n))

    def _on_podgroup(self, pg) -> None:
        row, _ = self.jobs.acquire(pg.meta.key)
        self._grow_job_arrays(row + 1)
        self.j_shadow[row] = False
        self.j_min[row] = pg.min_member
        qname = pg.queue or self.default_queue
        self.j_queue[row] = self.queues.key_row.get(qname, -1)
        self.j_prio[row] = self.priority_classes.get(
            pg.priority_class_name, self.default_priority)
        self.j_phase[row] = self._phase_idx[pg.status.phase]
        self.j_rv[row] = pg.meta.resource_version
        self.j_min_req[row] = 0.0
        if not self._vec(pg.min_resources, self.j_min_req[row]):
            self._widen_dims(pg.min_resources)
            return
        self.j_live[row] = True
        # link pods that arrived before their group
        waiting = self._waiting_on_group.pop(pg.meta.key, None)
        if waiting:
            for pod_key in waiting:
                self._pod_wait_group.pop(pod_key, None)
                prow = self.pods.key_row.get(pod_key)
                if prow is not None:
                    self.p_job[prow] = row
                self.unlinked_pods.discard(pod_key)

    def _del_podgroup(self, pg) -> None:
        pg_key = pg.meta.key
        row = self.jobs.release(pg_key)
        if row is not None:
            self.j_live[row] = False
            P = len(self.p_job)
            for prow in np.nonzero(self.p_live[:P] & (self.p_job[:P] == row))[0]:
                key = self.pods.row_key[prow]
                if key is not None:
                    self.p_job[prow] = -1
                    self.unlinked_pods.add(key)
                    self._set_wait(key, pg_key)

    @staticmethod
    def _shadow_key_for(pod) -> str:
        owner = pod.meta.owner
        if owner:
            return f"shadow/{pod.meta.namespace}/{owner[1]}"
        return f"shadow/{pod.meta.namespace}/{pod.meta.name}"

    def _ensure_shadow_row(self, key: str) -> int:
        row, new = self.jobs.acquire(key)
        if new:
            self._grow_job_arrays(row + 1)
            self.j_min[row] = 1
            self.j_queue[row] = self.queues.key_row.get(self.default_queue, -1)
            self.j_prio[row] = 0
            self.j_phase[row] = self._phase_idx[PodGroupPhase.INQUEUE]
            # shadow rows order after every real PodGroup, by creation
            self.j_rv[row] = (1 << 50) + self._shadow_seq
            self._shadow_seq += 1
            self.j_min_req[row] = 0.0
            self.j_shadow[row] = True
            self.j_members[row] = 0
            self.j_live[row] = True
        return row

    def _shadow_ref(self, jrow: int, delta: int) -> None:
        if jrow < 0 or not self.j_shadow[jrow]:
            return
        self.j_members[jrow] += delta
        if self.j_members[jrow] <= 0:
            key = self.jobs.row_key[jrow]
            if key is not None:
                self.jobs.release(key)
            self.j_live[jrow] = False

    def _set_wait(self, pod_key: str, group_key: str) -> None:
        self._clear_wait(pod_key)
        self._waiting_on_group.setdefault(group_key, set()).add(pod_key)
        self._pod_wait_group[pod_key] = group_key

    def _clear_wait(self, pod_key: str) -> None:
        group_key = self._pod_wait_group.pop(pod_key, None)
        if group_key is not None:
            waiting = self._waiting_on_group.get(group_key)
            if waiting is not None:
                waiting.discard(pod_key)
                if not waiting:
                    del self._waiting_on_group[group_key]

    # -- predicate classes ---------------------------------------------------

    def _class_id(self, pod) -> Optional[int]:
        """Intern the pod's static-predicate class key; None when the cap
        forced a resync (which re-ingested this pod)."""
        from volcano_tpu_torch.scheduler.snapshot import _task_class_key

        key = _task_class_key(pod)
        cid = self.class_ids.get(key)
        if cid is not None:
            return cid
        if len(self.class_examples) >= self._MAX_CLASSES:
            if self._resyncing:
                self.class_overflow = True
                return None
            self._resync(dims=self.dims)
            return None
        cid = len(self.class_examples)
        self.class_ids[key] = cid
        self.class_examples.append(pod)
        self._ensure_cls_capacity(cid, len(self.node_objs) - 1)
        return cid

    def _ensure_cls_capacity(self, cid: int, nrow: int) -> None:
        cap_c, cap_n = self.cls_mask.shape
        if cid < cap_c and nrow < cap_n:
            return
        new_c = max(cap_c, 8)
        while new_c <= cid:
            new_c *= 2
        new_n = max(cap_n, 64)
        while new_n <= nrow:
            new_n *= 2
        mask = np.zeros((new_c, new_n), bool)
        score = np.zeros((new_c, new_n), np.float32)
        valid = np.zeros((new_c, new_n), bool)
        mask[:cap_c, :cap_n] = self.cls_mask
        score[:cap_c, :cap_n] = self.cls_score
        valid[:cap_c, :cap_n] = self.cls_valid
        self.cls_mask, self.cls_score, self.cls_valid = mask, score, valid

    def fill_class_cells(self, cids: np.ndarray, node_rows: np.ndarray,
                         nodeaffinity_weight: float) -> None:
        """Compute any uncomputed (class, node) mask/score cells."""
        if not cids.size or not node_rows.size:
            return
        self._ensure_cls_capacity(int(cids.max()), int(node_rows.max()))
        from volcano_tpu_torch.scheduler.snapshot import (
            _static_predicate,
            node_affinity_score,
        )

        sub_valid = self.cls_valid[np.ix_(cids, node_rows)]
        if sub_valid.all():
            return
        missing_c, missing_n = np.nonzero(~sub_valid)
        for ci, ni in zip(missing_c, missing_n):
            cid = int(cids[ci])
            nrow = int(node_rows[ni])
            node = self.node_objs[nrow]
            if node is None:
                continue
            pod = self.class_examples[cid]
            ok = _static_predicate(pod, node)
            self.cls_mask[cid, nrow] = ok
            self.cls_score[cid, nrow] = (
                nodeaffinity_weight * node_affinity_score(pod, node) if ok else 0.0
            )
            self.cls_valid[cid, nrow] = True

    # -- pods -------------------------------------------------------------------

    def _on_pod(self, pod) -> None:
        if pod.spec.scheduler_name != self.scheduler_name:
            return
        key = pod.meta.key
        row, new = self.pods.acquire(key)
        old_j = int(self.p_job[row]) if not new and self.p_live[row] else -1
        for col in _POD_COLS:
            setattr(self, col, _grow(getattr(self, col), row + 1))
        if new:
            self.p_rank[row] = self._next_rank
            self._next_rank += 1
        cid = self._class_id(pod)
        if cid is None:
            return
        self.p_class[row] = cid
        resreq = pod.spec.resreq()
        init = pod.spec.init_resreq()
        self.p_resreq[row] = 0.0
        self.p_req[row] = 0.0
        if not self._vec(resreq, self.p_resreq[row]):
            self._widen_dims(resreq)
            return
        if not self._vec(init, self.p_req[row]):
            self._widen_dims(init)
            return
        prio = pod.spec.priority
        if prio == 0 and pod.spec.priority_class:
            prio = self.priority_classes.get(pod.spec.priority_class, self.default_priority)
        self.p_prio[row] = prio
        self.p_status[row] = _STATUS_CODE[task_status_of_pod(pod)]
        self.p_node[row] = self.nodes.key_row.get(pod.node_name, -1)
        group = pod.meta.annotations.get(POD_GROUP_KEY, "")
        if group:
            group_key = f"{pod.meta.namespace}/{group}"
            jrow = self.jobs.key_row.get(group_key, -1)
            self.p_job[row] = jrow
            if jrow < 0:
                self.unlinked_pods.add(key)
                self._set_wait(key, group_key)
            else:
                self.unlinked_pods.discard(key)
                self._clear_wait(key)
        else:
            self.unlinked_pods.discard(key)
            self._clear_wait(key)
            self.p_job[row] = self._ensure_shadow_row(self._shadow_key_for(pod))
        new_j = int(self.p_job[row])
        if new_j != old_j:
            self._shadow_ref(new_j, +1)
            self._shadow_ref(old_j, -1)
        self.p_best_effort[row] = resreq.is_empty()
        aff = pod.spec.affinity
        self.p_dynamic[row] = bool(
            pod.spec.host_ports
            or (aff is not None and (aff.pod_affinity or aff.pod_anti_affinity))
        )
        self.p_has_vol[row] = bool(pod.volumes)
        self.p_live[row] = True

    def _del_pod(self, pod) -> None:
        self._del_pod_key(pod.meta.key)

    def refresh_pod(self, key: str) -> None:
        """Re-read one pod from the store (publish failure recovery)."""
        pod = self.store.get("Pod", key)
        if pod is None:
            self._del_pod_key(key)
        else:
            self._on_pod(pod)

    def _del_pod_key(self, key: str) -> None:
        row = self.pods.release(key)
        self.unlinked_pods.discard(key)
        self._clear_wait(key)
        if row is not None and self.p_live[row]:
            self.p_live[row] = False
            self._shadow_ref(int(self.p_job[row]), -1)

    # -- eligibility ----------------------------------------------------------

    def ineligible_reason(self) -> Optional[str]:
        """Why this cluster is outside the port's express slice, or None:
        the structural conditions of the JAX mirror, plus pending pods that
        need resident-state predicates (host ports, pod (anti)affinity) or
        volumes — the JAX cycle hands their jobs to the dynamic solve or the
        object sub-cycle, which this port does not have yet."""
        if self.class_overflow:
            return "predicate class cap exceeded"
        if self.unlinked_pods:
            return "pods whose PodGroup is absent"
        P = len(self.p_live)
        pend = self.p_live[:P] & (self.p_status[:P] == _PENDING)
        if (pend & self.p_dynamic[:P]).any():
            return "pending pods with host ports or pod (anti)affinity"
        if (pend & self.p_has_vol[:P]).any():
            return "pending pods with volumes"
        return None

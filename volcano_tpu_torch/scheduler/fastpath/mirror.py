"""Watch-fed array mirror of the store — the fast cycle's state layer.

The port's copy of ``volcano_tpu/scheduler/fastpath/mirror.py``: store
watch events apply to numpy row tables in O(changes), and the snapshot
builder reads the tables vectorized.  Kept: pods, nodes, PodGroups (plus
shadow gangs for group-less pods), queues, priority classes, the lazily
filled per-(predicate class, node) cells, and the interned host ports and
pod (anti)affinity selectors with their per-node resident counts (the
dynamic solve's state), and the conformance veto of the contention passes
(``p_evictable``; a pod being deleted is RELEASING, its capacity counted
as releasing by the snapshot), and the pods that mount volumes
(``p_has_vol``, with their objects in ``vol_pod_objs``): their verdicts are
resolved once a cycle from the store's PV/PVC/StorageClass state by
``build_fast_snapshot`` (``volsolve.py``), so the volume kinds are watched
but carry no mirror state.  PodDisruptionBudgets configure the shadow gang
of their controller's plain pods (``j_pdb``: MinMember from the budget; a
budget-backed row outlives its member pods).  Every pod, node and
PodGroup row keeps its object's resource version (``p_rv``, ``n_rv``,
``j_rv``), so that a checkpoint (``save_checkpoint``) restores in a
restarted scheduler and re-reads only the objects whose version moved
while it was cold (``try_restore_checkpoint``).  Left out (ROADMAP item
11): the digest audit.
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
    "p_best_effort", "p_live", "p_rank", "p_dynamic", "p_dyn_expr", "p_has_vol",
    "p_class", "p_ports", "p_selmatch", "p_aff_req", "p_aff_anti", "p_contrib_node",
    "p_evictable", "p_rv",
)
_JOB_COLS = (
    "j_min", "j_queue", "j_prio", "j_phase", "j_rv", "j_min_req", "j_live",
    "j_shadow", "j_pdb", "j_members",
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
            for kind in ("Pod", "Node", "PodGroup", "Queue", "PriorityClass",
                         "PodDisruptionBudget", "PV", "PVC", "StorageClass")
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
        # resident-state predicates (host ports, pod (anti)affinity); a
        # dynamic pod whose ports and selectors all interned is expressible
        # (p_dyn_expr) and the device dynamic solve serves it
        self.p_dynamic = np.zeros((0,), bool)
        self.p_dyn_expr = np.zeros((0,), bool)
        # claim-referencing pods (pod.volumes non-empty): their verdict
        # (express, device volume solve or residue) is resolved once a cycle
        # from the store, and vol_pod_objs keeps their objects so that it
        # needs no store round trip per pod
        self.p_has_vol = np.zeros((0,), bool)
        self.vol_pod_objs: Dict[int, object] = {}
        self.p_class = np.zeros((0,), np.int32)
        # conformance veto: system-critical pods are never victims
        self.p_evictable = np.zeros((0,), bool)
        self.p_rv = np.zeros((0,), np.int64)            # resource_version
        self._next_rank = 0

        self.nodes = _Rows(reuse=False)
        self.n_alloc = np.zeros((0, R), np.float32)
        self.n_max_tasks = np.zeros((0,), np.int32)
        self.n_live = np.zeros((0,), bool)
        self.n_rv = np.zeros((0,), np.int64)            # resource_version
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
        # 1 unless a PodDisruptionBudget configures it, default queue,
        # priority 0, always schedulable, no status writes.  j_pdb marks
        # budget-backed gangs, which outlive their member pods; j_members
        # refcounts live member pods so that a member-less, budget-less row
        # is released
        self.j_shadow = np.zeros((0,), bool)
        self.j_pdb = np.zeros((0,), bool)
        self.j_members = np.zeros((0,), np.int32)
        self._shadow_seq = 0
        self.unlinked_pods: Set[str] = set()
        self._waiting_on_group: Dict[str, Set[str]] = {}
        self._pod_wait_group: Dict[str, str] = {}

        self.queues = _Rows()
        self.q_weight = np.zeros((0,), np.float32)
        self.q_live = np.zeros((0,), bool)

        # host ports and exact-match pod (anti)affinity selectors intern to
        # bit positions: per-pod bitset rows, per-node resident counts
        # kept O(changes).  A port or selector past the cap leaves its pod
        # dynamic but not expressible (its job goes to the object path)
        self.PW = 4   # u32 words -> 128 distinct host ports
        self.SW = 2   # u32 words -> 64 distinct affinity selectors
        self.port_ids: Dict[int, int] = {}
        self.sel_ids: Dict[frozenset, int] = {}
        self.p_ports = np.zeros((0, self.PW), np.uint32)     # own host ports
        self.p_selmatch = np.zeros((0, self.SW), np.uint32)  # labels satisfy
        self.p_aff_req = np.zeros((0, self.SW), np.uint32)   # required terms
        self.p_aff_anti = np.zeros((0, self.SW), np.uint32)  # anti terms
        # node row each pod's bits are counted on, or -1
        self.p_contrib_node = np.zeros((0,), np.int32)
        self.p_labels: List[Optional[dict]] = []
        self.n_port_cnt = np.zeros((0, 32 * self.PW), np.int16)
        self.n_sel_cnt = np.zeros((0, 32 * self.SW), np.int16)

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
        # budgets before pods, like the object snapshot: a budget creates or
        # configures the shadow gang its controller's plain pods join
        for pdb in self.store.items("PodDisruptionBudget"):
            self._on_pdb(pdb)
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
                elif kind in ("Queue", "PriorityClass"):
                    # queue / priority-class changes re-wire job and pod rows
                    resync = True
                elif kind == "PodDisruptionBudget":
                    self._del_pdb(ev.obj) if deleted else self._on_pdb(ev.obj)
                # volume objects carry no mirror state: the snapshot reads
                # them from the store once a cycle
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
        self.n_rv = _grow(self.n_rv, n)
        self.n_port_cnt = _grow(self.n_port_cnt, n)
        self.n_sel_cnt = _grow(self.n_sel_cnt, n)
        if new:
            # a node deleted and re-created takes its resident pods along,
            # and their port / selector counts with them
            retired = self._retired_node_rows.pop(node.meta.name, None)
            if retired:
                stale = np.isin(self.p_node, np.asarray(retired, np.int32))
                moved = np.nonzero(stale & self.p_live[: self.p_node.shape[0]])[0]
                self.p_node[moved] = row
                for prow in moved:
                    self._sub_contrib(int(prow))
                    self._add_contrib(int(prow), row)
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
        self.n_rv[row] = node.meta.resource_version
        self.n_live[row] = True
        if self.cls_valid.shape[1] > row:
            self.cls_valid[:, row] = False

    def _del_node(self, node) -> None:
        self._del_node_key(node.meta.name)

    def _del_node_key(self, name: str) -> None:
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
        self._del_podgroup_key(pg.meta.key)

    def _del_podgroup_key(self, pg_key: str) -> None:
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
            self.j_pdb[row] = False
            self.j_members[row] = 0
            self.j_live[row] = True
        return row

    def _shadow_ref(self, jrow: int, delta: int) -> None:
        if jrow < 0 or not self.j_shadow[jrow]:
            return
        self.j_members[jrow] += delta
        if self.j_members[jrow] <= 0 and not self.j_pdb[jrow]:
            key = self.jobs.row_key[jrow]
            if key is not None:
                self.jobs.release(key)
            self.j_live[jrow] = False

    @staticmethod
    def _pdb_key(pdb) -> str:
        return f"shadow/{pdb.meta.namespace}/{pdb.meta.owner[1]}"

    def _on_pdb(self, pdb) -> None:
        """setPDB: the budget's controller owner names the shadow gang, its
        MinAvailable the gang's minimum."""
        if pdb.meta.owner is None:
            return  # a budget without a controller configures nothing
        row = self._ensure_shadow_row(self._pdb_key(pdb))
        self.j_min[row] = pdb.min_available
        self.j_pdb[row] = True

    def _del_pdb(self, pdb) -> None:
        """A deleted budget reverts its gang to the plain-pod MinMember of
        1, and a member-less row loses its reason to exist."""
        if pdb.meta.owner is None:
            return
        row = self.jobs.key_row.get(self._pdb_key(pdb))
        if row is not None and self.j_shadow[row]:
            self.j_min[row] = 1
            self.j_pdb[row] = False
            self._shadow_ref(row, 0)

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

    # -- port/selector interning ---------------------------------------------

    def _intern_port(self, port: int) -> Optional[int]:
        pid = self.port_ids.get(port)
        if pid is None:
            if len(self.port_ids) >= 32 * self.PW:
                return None
            pid = len(self.port_ids)
            self.port_ids[port] = pid
        return pid

    def _intern_selector(self, sel: Dict[str, str]) -> Optional[int]:
        key = frozenset(sel.items())
        sid = self.sel_ids.get(key)
        if sid is None:
            if len(self.sel_ids) >= 32 * self.SW:
                return None
            sid = len(self.sel_ids)
            self.sel_ids[key] = sid
            # pods seen before this selector: set its bit where their labels
            # match (and count it on their nodes), once per new selector
            self._backfill_selector(key, sid)
        return sid

    def _backfill_selector(self, sel_items, sid: int) -> None:
        w, b = divmod(sid, 32)
        bit = np.uint32(1 << b)
        P = min(len(self.p_labels), self.p_selmatch.shape[0])
        for row in np.nonzero(self.p_live[:P])[0]:
            labels = self.p_labels[row]
            if labels and all(labels.get(k) == v for k, v in sel_items):
                self.p_selmatch[row, w] |= bit
                crow = self.p_contrib_node[row]
                if crow >= 0:
                    self.n_sel_cnt[crow, sid] += 1

    @staticmethod
    def _bit_indices(words) -> List[int]:
        out = []
        for w in range(words.shape[0]):
            word = int(words[w])
            while word:
                b = (word & -word).bit_length() - 1
                out.append(w * 32 + b)
                word &= word - 1
        return out

    def _sub_contrib(self, row: int) -> None:
        """Take the pod's port and selector bits off its node's counts."""
        crow = int(self.p_contrib_node[row])
        if crow < 0:
            return
        if self.p_ports[row].any():
            self.n_port_cnt[crow, self._bit_indices(self.p_ports[row])] -= 1
        if self.p_selmatch[row].any():
            self.n_sel_cnt[crow, self._bit_indices(self.p_selmatch[row])] -= 1
        self.p_contrib_node[row] = -1

    def _add_contrib(self, row: int, crow: int) -> None:
        if self.p_ports[row].any():
            self.n_port_cnt[crow, self._bit_indices(self.p_ports[row])] += 1
        if self.p_selmatch[row].any():
            self.n_sel_cnt[crow, self._bit_indices(self.p_selmatch[row])] += 1
        self.p_contrib_node[row] = crow

    def _intern_pod_bits(self, row: int, pod) -> bool:
        """Fill the pod's port / selector rows; False when a port or a
        selector did not fit the intern caps."""
        labels = pod.meta.labels or {}
        self.p_labels[row] = labels
        spec = pod.spec
        expr_ok = True
        ports = np.zeros(self.PW, np.uint32)
        for port in spec.host_ports:
            pid = self._intern_port(port)
            if pid is None:
                expr_ok = False
            else:
                ports[pid // 32] |= np.uint32(1 << (pid % 32))
        req = np.zeros(self.SW, np.uint32)
        anti = np.zeros(self.SW, np.uint32)
        aff = spec.affinity
        if aff is not None:
            for sel, out in ([(x, req) for x in aff.pod_affinity]
                             + [(x, anti) for x in aff.pod_anti_affinity]):
                sid = self._intern_selector(sel)
                if sid is None:
                    expr_ok = False
                else:
                    out[sid // 32] |= np.uint32(1 << (sid % 32))
        match = np.zeros(self.SW, np.uint32)
        if self.sel_ids and labels:
            for sel_items, sid in self.sel_ids.items():
                if all(labels.get(k) == v for k, v in sel_items):
                    match[sid // 32] |= np.uint32(1 << (sid % 32))
        self.p_ports[row] = ports
        self.p_selmatch[row] = match
        self.p_aff_req[row] = req
        self.p_aff_anti[row] = anti
        return expr_ok

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
        while len(self.p_labels) < row + 1:
            self.p_labels.append(None)
        if new:
            self.p_rank[row] = self._next_rank
            self._next_rank += 1
            self.p_contrib_node[row] = -1
        elif self.p_live[row]:
            # the old state's bits leave its node before anything changes
            self._sub_contrib(row)
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
        self.vol_pod_objs.pop(row, None)
        if pod.volumes:
            self.vol_pod_objs[row] = pod
        self.p_dyn_expr[row] = self._intern_pod_bits(row, pod) and self.p_dynamic[row]
        self.p_evictable[row] = not (
            pod.spec.priority_class in ("system-cluster-critical", "system-node-critical")
            or pod.meta.namespace == "kube-system"
        )
        self.p_live[row] = True
        self.p_rv[row] = pod.meta.resource_version
        crow = int(self.p_node[row])
        if crow >= 0:
            self._add_contrib(row, crow)

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
        if row is not None:
            self.vol_pod_objs.pop(row, None)
        if row is not None and self.p_live[row]:
            self.p_live[row] = False
            self._sub_contrib(row)
            self.p_labels[row] = None
            self._shadow_ref(int(self.p_job[row]), -1)

    # -- checkpoint (warm restart) ---------------------------------------------

    #: the checkpoint's layout version; bump on any change of the row tables
    _CKPT_VERSION = 1
    #: live handles that never go into a checkpoint
    _CKPT_SKIP = ("store", "_watches")

    def save_checkpoint(self, path: str) -> None:
        """Persist the whole mirror (row tables, interning maps, the objects
        it keeps) with the store's resource version and lineage uid,
        atomically (a temporary file, then a rename)."""
        import os
        import pickle

        payload = {
            "version": self._CKPT_VERSION,
            "scheduler_name": self.scheduler_name,
            "default_queue": self.default_queue,
            "store_rv": self.store.resource_version,
            "store_uid": getattr(self.store, "uid", None),
            "state": {k: v for k, v in self.__dict__.items() if k not in self._CKPT_SKIP},
        }
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)

    def try_restore_checkpoint(self, path: str) -> bool:
        """Restore a checkpoint, then reconcile it against the live store by
        per-object resource version.  False, with the mirror untouched, when
        the file is unreadable, from another scheduler name or default
        queue, from another store lineage (another uid, or a store younger
        than the checkpoint): the caller then lists the cluster."""
        import pickle

        try:
            with open(path, "rb") as f:
                payload = pickle.load(f)
        except Exception:  # noqa: BLE001 — unreadable or corrupt: a full list
            return False
        if (not isinstance(payload, dict)
                or payload.get("version") != self._CKPT_VERSION
                or payload.get("scheduler_name") != self.scheduler_name
                or payload.get("default_queue") != self.default_queue):
            return False
        ck_uid, cur_uid = payload.get("store_uid"), getattr(self.store, "uid", None)
        if ck_uid is not None and cur_uid is not None and ck_uid != cur_uid:
            return False
        if self.store.resource_version < payload.get("store_rv", 0):
            return False
        self.__dict__.update(payload["state"])
        self._reconcile_store()
        self._synced = True
        return True

    def _reconcile_store(self) -> None:
        """The delta relist: re-ingest the objects whose resource version
        moved while the checkpoint was cold and drop the vanished ones.
        Every ingest is idempotent, so the watch events queued meanwhile
        re-apply harmlessly at the next drain."""
        store = self.store
        # queues and priority classes re-wire job and pod rows: any drift
        # there takes the (cheap at their cardinality) full resync
        qs = store.list("Queue")
        q_ok = len(qs) == len(self.queues.key_row)
        for q in qs:
            r = self.queues.key_row.get(q.meta.name)
            q_ok = q_ok and r is not None and bool(self.q_live[r]) and (
                self.q_weight[r] == q.weight)
        pcs = {pc.meta.name: pc.value for pc in store.items("PriorityClass")}
        defp = 0
        for pc in store.items("PriorityClass"):
            if pc.global_default:
                defp = pc.value
        if not q_ok or pcs != self.priority_classes or defp != self.default_priority:
            self._resync(dims=self.dims)
            return
        seen = set()
        for node in store.items("Node"):
            seen.add(node.meta.name)
            row = self.nodes.key_row.get(node.meta.name)
            if row is None or not self.n_live[row] or self.n_rv[row] != node.meta.resource_version:
                self._on_node(node)
        for name in [k for k in self.nodes.key_row if k not in seen]:
            self._del_node_key(name)
        seen = set()
        for pg in store.items("PodGroup"):
            seen.add(pg.meta.key)
            row = self.jobs.key_row.get(pg.meta.key)
            if row is None or not self.j_live[row] or self.j_rv[row] != pg.meta.resource_version:
                self._on_podgroup(pg)
        for key in [k for k in self.jobs.key_row if not k.startswith("shadow/") and k not in seen]:
            self._del_podgroup_key(key)
        # budgets: re-apply all, demote the rows whose budget vanished
        pdb_rows = set()
        for pdb in store.items("PodDisruptionBudget"):
            self._on_pdb(pdb)
            if pdb.meta.owner is not None:
                r = self.jobs.key_row.get(self._pdb_key(pdb))
                if r is not None:
                    pdb_rows.add(r)
        for r in np.nonzero(self.j_pdb & self.j_live)[0]:
            if int(r) not in pdb_rows:
                self.j_min[r] = 1
                self.j_pdb[r] = False
                self._shadow_ref(int(r), 0)
        seen = set()
        for pod in store.items("Pod"):
            if pod.spec.scheduler_name != self.scheduler_name:
                continue
            key = pod.meta.key
            seen.add(key)
            row = self.pods.key_row.get(key)
            if row is None or not self.p_live[row] or self.p_rv[row] != pod.meta.resource_version:
                self._on_pod(pod)
        for key in [k for k in self.pods.key_row if k not in seen]:
            self._del_pod_key(key)

    # -- eligibility ----------------------------------------------------------

    def ineligible_reason(self) -> Optional[str]:
        """Why this cluster is outside the fast cycle, or None: the
        structural conditions of the JAX mirror.  Pending pods with host
        ports, pod (anti)affinity or volumes are in: the snapshot
        partitions their jobs out of the express solve."""
        if self.class_overflow:
            return "predicate class cap exceeded"
        if self.unlinked_pods:
            return "pods whose PodGroup is absent"
        return None

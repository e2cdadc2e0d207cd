"""Per-cycle volume interning for the dynamic solve's volume extension.

The port's copy of ``volcano_tpu/scheduler/volsolve.py`` (the cycle
times the whole pass as its ``vol_solve`` phase; an armed profiler also
counts the claims interned, ``volsolve.claims``, and times the payload
build, ``volsolve.payload``).  Once per cycle it turns the store's
PVC/PV/StorageClass state into the device payload that the exact allocate
solve's ``volsel`` extension (K6) tests and decrements:

  * every referenced claim interns to a feasible-node set:
      - bound PVC -> the bound PV's reachable nodes (its node affinity
        matched against node labels; a missing bound PV is unschedulable
        everywhere);
      - pending claim of a static class -> the class pool's reachable
        nodes, through the capacity tensor below;
      - WaitForFirstConsumer dynamic classes and claims without a PVC
        object do not constrain (they never reach the kernel);
  * every static class with a *uniform* pool interns to a row of the
    per-(storage class, node) attach-capacity tensor: the count of
    Available un-assumed PVs reachable from each node, decremented in the
    kernel as claims assume volumes, so that two claims contending for one
    PV resolve on the device as in the host binder's assume-cache.

Shapes the count model cannot express get a residue verdict with a reason
class, and the fast cycle's object sub-cycle places them on the host
residue engine (``scheduler/residue.py``):

  * a class pool mixing network and node-pinned PVs, or a PV whose
    affinity matches several nodes;
  * a pool whose smallest PV does not fit the largest routed claim;
  * one pod mounting two unbound claims of the same class;
  * a claim group shared with a residue-classed job (the contention
    closure);
  * more distinct constraining claims than ``CLAIM_CAP``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from volcano_tpu_torch import vtprof
from volcano_tpu_torch.api.resource import parse_quantity
from volcano_tpu_torch.scheduler import kernels
from volcano_tpu_torch.scheduler.snapshot import _bucket

#: distinct constraining claims the device payload can carry per cycle (the
#: kernel's two u32 claim words a task); overflow routes the overflowing
#: jobs to the residue engine (the same discipline as the port/selector
#: intern caps)
CLAIM_CAP = kernels.CLAIM_CAP

#: well-known single-node pin label (objects.Node stamps it on every node)
_HOSTNAME_LABEL = "kubernetes.io/hostname"

# claim verdict kinds
FREE = "free"          # non-constraining: never enters the kernel
MASK = "mask"          # bound claim: static feasible-node bitset only
GROUP = "group"        # pending static claim: capacity-tensor group member
RESIDUE = "residue"    # inexpressible shape: host residue engine


class ClaimInfo:
    __slots__ = ("key", "kind", "mask", "group", "reason", "size")

    def __init__(self, key: str, kind: str, mask=None, group: int = -1,
                 reason: str = "", size: float = 0.0):
        self.key = key
        self.kind = kind
        self.mask = mask          # [n_live] bool for MASK claims
        self.group = group        # group index for GROUP claims
        self.reason = reason      # residue reason class
        self.size = size


class VolumeCycleIndex:
    """One cycle's interned volume state: claim verdicts, capacity
    groups, and per-node reachability masks over the live-node axis."""

    def __init__(self, store, node_objs: List, n_live: int):
        self.store = store
        self.node_objs = node_objs    # live-node index -> Node object
        self.n_live = n_live
        self.claims: Dict[str, ClaimInfo] = {}
        # group id -> (cap [n_live] i32, global flag)
        self.group_cap: List[np.ndarray] = []
        self.group_global: List[bool] = []
        self._group_of_class: Dict[str, int] = {}
        self._pvs = list(store.items("PV"))
        self._pv_by_name = {pv.meta.name: pv for pv in self._pvs}
        self._static: Dict[str, bool] = {}
        self._affinity_masks: Dict[tuple, np.ndarray] = {}
        self._host_rows: Optional[Dict[str, List[int]]] = None
        self._qty: Dict[str, float] = {}
        # group id -> smallest pool-PV capacity (fit-uniformity floor)
        self._group_floor: Dict[int, float] = {}

    # -- label/affinity machinery -------------------------------------------

    def _quantity(self, s: str) -> float:
        v = self._qty.get(s)
        if v is None:
            v = self._qty[s] = parse_quantity("memory", s)
        return v

    def _hostname_rows(self) -> Dict[str, List[int]]:
        if self._host_rows is None:
            rows: Dict[str, List[int]] = {}
            for i in range(self.n_live):
                node = self.node_objs[i]
                if node is None:
                    continue
                h = node.labels.get(_HOSTNAME_LABEL, node.meta.name)
                rows.setdefault(h, []).append(i)
            self._host_rows = rows
        return self._host_rows

    def affinity_mask(self, affinity: Dict[str, str]) -> np.ndarray:
        """[n_live] bool of nodes whose labels satisfy ``affinity``
        (VolumeBinder._affinity_matches semantics).  The single-key
        hostname pin — the overwhelmingly common local-PV shape — resolves
        through one prebuilt map instead of an O(N) label scan."""
        if not affinity:
            return np.ones(self.n_live, bool)
        key = tuple(sorted(affinity.items()))
        mask = self._affinity_masks.get(key)
        if mask is not None:
            return mask
        mask = np.zeros(self.n_live, bool)
        if len(affinity) == 1 and _HOSTNAME_LABEL in affinity:
            for i in self._hostname_rows().get(affinity[_HOSTNAME_LABEL], ()):
                mask[i] = True
        else:
            for i in range(self.n_live):
                node = self.node_objs[i]
                if node is not None and all(
                    node.labels.get(k) == v for k, v in affinity.items()
                ):
                    mask[i] = True
        self._affinity_masks[key] = mask
        return mask

    def _is_static_class(self, class_name: str) -> bool:
        cached = self._static.get(class_name)
        if cached is not None:
            return cached
        sc = self.store.get("StorageClass", f"/{class_name}")
        if sc is not None:
            static = not sc.provisioner
        else:
            static = any(
                pv.storage_class == class_name and not pv.provisioned
                for pv in self._pvs
            )
        self._static[class_name] = static
        return static

    # -- claim resolution ----------------------------------------------------

    def resolve(self, claim_key: str) -> ClaimInfo:
        info = self.claims.get(claim_key)
        if info is not None:
            return info
        info = self.claims[claim_key] = self._resolve(claim_key)
        prof = vtprof.PROFILER
        if prof is not None:
            # the claims interned this cycle: the volume pass's share of
            # the profile's host breakdown
            prof.count("volsolve.claims")
        return info

    def _resolve(self, claim_key: str) -> ClaimInfo:
        pvc = self.store.get("PVC", claim_key)
        if pvc is None:
            # no PVC object: the binder's _pending_claims skips it too
            # (emptyDir/configMap-style mounts) — never constrains
            return ClaimInfo(claim_key, FREE)
        if pvc.volume_name:
            pv = self._pv_by_name.get(pvc.volume_name)
            if pv is None:
                # bound PV deleted: unschedulable everywhere (the host
                # volume_fit's "not found" verdict), expressible as an
                # all-zeros mask
                return ClaimInfo(
                    claim_key, MASK, mask=np.zeros(self.n_live, bool)
                )
            if not pv.node_affinity:
                return ClaimInfo(claim_key, FREE)  # network PV: no veto
            return ClaimInfo(
                claim_key, MASK, mask=self.affinity_mask(pv.node_affinity)
            )
        if not self._is_static_class(pvc.storage_class):
            return ClaimInfo(claim_key, FREE)  # dynamic: provision at bind
        size = self._quantity(pvc.size) if pvc.size else 0.0
        return ClaimInfo(
            claim_key, GROUP,
            group=self._class_group(pvc.storage_class),
            size=size,
        )

    def _class_group(self, class_name: str) -> int:
        """Group id for a static class's capacity row, or -1 when the
        pool shape is count-inexpressible."""
        gid = self._group_of_class.get(class_name)
        if gid is not None:
            return gid
        pool = [
            pv for pv in self._pvs
            if pv.storage_class == class_name and not pv.claim_ref
        ]
        if not pool:
            # exhausted static pool: unschedulable everywhere, exactly the
            # host's "no available volume" verdict — an all-zero capacity
            # row expresses it (and can never be decremented)
            gid = len(self.group_cap)
            self.group_cap.append(np.zeros(self.n_live, np.int32))
            self.group_global.append(True)
            self._group_of_class[class_name] = gid
            self._group_floor[gid] = float("inf")
            return gid
        gid = -1
        pinned = [pv for pv in pool if pv.node_affinity]
        if not pinned:
            # all network PVs: one global counter, reachable everywhere
            cap = np.full(self.n_live, len(pool), np.int32)
            gid = len(self.group_cap)
            self.group_cap.append(cap)
            self.group_global.append(True)
            # min pool capacity gates fit uniformity (checked per claim
            # in classify_task against this group's floor)
        elif len(pinned) == len(pool):
            cap = np.zeros(self.n_live, np.int32)
            ok = True
            for pv in pool:
                m = self.affinity_mask(pv.node_affinity)
                if int(m.sum()) > 1:
                    ok = False  # multi-node PV: counts not conserved
                    break
                cap += m.astype(np.int32)
            if ok:
                gid = len(self.group_cap)
                self.group_cap.append(cap)
                self.group_global.append(False)
        # else: mixed network+pinned pool — inexpressible
        self._group_of_class[class_name] = gid
        if gid >= 0:
            self._group_floor[gid] = min(
                (self._quantity(pv.capacity) if pv.capacity else float("inf"))
                for pv in pool
            )
        return gid

    def group_floor(self, gid: int) -> float:
        return self._group_floor.get(gid, 0.0)


class TaskVolumes:
    """One pending pod's volume verdict."""

    __slots__ = ("verdict", "reason", "mask", "claim_ids", "groups")

    def __init__(self, verdict: str, reason: str = "",
                 mask=None, claim_ids: Tuple[int, ...] = (),
                 groups: Tuple[int, ...] = ()):
        self.verdict = verdict      # FREE | MASK/GROUP (device) | RESIDUE
        self.reason = reason
        self.mask = mask            # [n_live] bool (bound-claim AND), or None
        self.claim_ids = claim_ids  # interned GROUP-claim slots
        # EVERY capacity group the pod's claims touch — recorded for
        # residue verdicts too (a size-overflow claim still competes for
        # its class's pool), so the contention closure can serialize
        # device/residue claimants of one pool through one session
        self.groups = groups


class VolumePartition:
    """The cycle-level volume partition: per-pod verdicts plus the packed
    device payload for the dynamic solve."""

    def __init__(self, index: VolumeCycleIndex):
        self.index = index
        # GROUP claim key -> interned slot id (device claim axis)
        self.claim_slots: Dict[str, int] = {}
        self.slot_claims: List[str] = []
        self.slot_group: List[int] = []
        self.task_volumes: Dict[int, TaskVolumes] = {}  # mirror row -> verdict
        # groups referenced by any residue-classed claim: their device jobs
        # must join the residue too (one session must own the contention)
        self.contended_groups: set = set()

    def classify_task(self, row: int, claim_keys: List[str]) -> TaskVolumes:
        """Verdict for one pending pod's claims (memoized per row)."""
        tv = self.task_volumes.get(row)
        if tv is not None:
            return tv
        idx = self.index
        mask: Optional[np.ndarray] = None
        group_claims: List[str] = []
        touched: List[int] = []  # every capacity group the pod competes for
        reason = ""
        verdict = FREE
        for key in claim_keys:
            info = idx.resolve(key)
            if info.kind == FREE:
                continue
            if info.kind == MASK:
                verdict = "device"
                mask = info.mask if mask is None else (mask & info.mask)
            elif info.kind == GROUP:
                verdict = "device"
                if info.group >= 0:
                    touched.append(info.group)
                if info.group < 0:
                    reason = "volume-shape"
                elif info.size > idx.group_floor(info.group):
                    # a pool PV smaller than this claim: the host's
                    # smallest-fitting choice becomes claim-specific
                    reason = "volume-shape"
                else:
                    group_claims.append(key)
        if not reason:
            groups = [idx.resolve(k).group for k in group_claims]
            if len(set(groups)) != len(groups):
                # two unbound claims of one class in one pod: the host
                # predicate passes but allocate_volumes fails the second —
                # inexpressible as independent per-claim count checks
                reason = "volume-shape"
        if reason:
            # the pod still competes for every pool it touches, even the
            # ones that triggered the residue verdict — seed the
            # contention closure with all of them
            tv = TaskVolumes(RESIDUE, reason=reason, groups=tuple(touched))
            self.contended_groups.update(touched)
        elif verdict == FREE:
            tv = TaskVolumes(FREE)
        else:
            ids = []
            overflow = False
            for key in group_claims:
                slot = self.claim_slots.get(key)
                if slot is None:
                    if len(self.slot_claims) >= CLAIM_CAP:
                        overflow = True
                        break
                    slot = len(self.slot_claims)
                    self.claim_slots[key] = slot
                    self.slot_claims.append(key)
                    self.slot_group.append(idx.resolve(key).group)
                ids.append(slot)
            if overflow:
                tv = TaskVolumes(RESIDUE, reason="volume-claim-cap",
                                 groups=tuple(touched))
                self.contended_groups.update(touched)
            else:
                tv = TaskVolumes("device", mask=mask, claim_ids=tuple(ids),
                                 groups=tuple(touched))
        self.task_volumes[row] = tv
        return tv

    def demote_contended_jobs(self, row_job: Dict[int, int],
                              resid_jobs) -> Dict[int, str]:
        """Job-level contention closure — the ONE owner of the
        serialization invariant: once ANY job competing for a capacity
        group is residue-classed (inexpressible sibling claims, size
        overflow, claim-cap overflow, BE pods, intern overflow), every
        device job sharing one of its groups must follow, transitively —
        the host oracle serializes those assumptions through one session
        and a device-side decrement could not see the residue side's.

        ``row_job``: mirror pod row -> job index; ``resid_jobs``: job
        indices already residue-classed.  Returns {job index: reason} for
        the additional demotions."""
        job_groups: Dict[int, set] = {}
        for row, tv in self.task_volumes.items():
            j = row_job.get(row, -1)
            if j < 0 or not tv.groups:
                continue
            job_groups.setdefault(j, set()).update(tv.groups)
        contended = set(self.contended_groups)
        for j in resid_jobs:
            contended.update(job_groups.get(j, ()))
        demoted: Dict[int, str] = {}
        changed = True
        while changed:
            changed = False
            for j, gs in job_groups.items():
                if j in resid_jobs or j in demoted:
                    continue
                if gs & contended:
                    demoted[j] = "contended-claims"
                    contended |= gs
                    changed = True
        return demoted

    # -- device payload ------------------------------------------------------

    def payload(self, rows: np.ndarray, T: int, N: int) -> Optional[dict]:
        """``_payload``, timed as the host sub-segment ``volsolve.payload``
        while the profiler is armed."""
        prof = vtprof.PROFILER
        t0 = time.perf_counter() if prof is not None else 0.0
        out = self._payload(rows, T, N)
        if prof is not None:
            prof.note_host("volsolve.payload", time.perf_counter() - t0)
        return out

    def _payload(self, rows: np.ndarray, T: int, N: int) -> Optional[dict]:
        """Device arrays for the dyn-solve task layout, in the JAX
        package's form (``kernels.pack_volsel`` packs the claim bits for
        the solve); None when no routed task carries volume state.

        ``rows``: mirror pod rows in task order (the dyn solve's first
        len(rows) task slots).  ``N`` is the snapshot's bucketed node axis;
        masks/caps are built over the live prefix and padded.
        """
        relevant = [
            i for i, r in enumerate(rows)
            if self.task_volumes.get(int(r)) is not None
            and self.task_volumes[int(r)].verdict == "device"
            and (self.task_volumes[int(r)].mask is not None
                 or self.task_volumes[int(r)].claim_ids)
        ]
        if not relevant:
            return None
        NW = max(1, (N + 31) // 32)
        n_live = self.index.n_live
        groups = self.index.group_cap
        groups_global = self.index.group_global
        C = _bucket(max(len(self.slot_claims), 1), minimum=8)
        G = _bucket(max(len(groups), 1), minimum=4)

        task_volmask = np.zeros((T, NW), np.uint32)
        # default: all-ones over every word (invalid node columns are
        # already excluded by node_valid in the kernel)
        task_volmask[:] = np.uint32(0xFFFFFFFF)
        task_claims = np.zeros((T, C), bool)
        bit_w = np.arange(n_live) // 32
        bit_b = np.uint32(1) << (np.arange(n_live) % 32).astype(np.uint32)
        for i in relevant:
            tv = self.task_volumes[int(rows[i])]
            if tv.mask is not None:
                row_words = np.zeros(NW, np.uint32)
                on = np.nonzero(tv.mask)[0]
                np.bitwise_or.at(row_words, bit_w[on], bit_b[on])
                # pad words beyond the live prefix stay zero — fine, those
                # columns are node_valid=False anyway
                task_volmask[i] = row_words
            for s in tv.claim_ids:
                task_claims[i, s] = True

        claim_group = np.zeros(C, np.int32)
        for s, g in enumerate(self.slot_group):
            claim_group[s] = g
        group_cap = np.zeros((G, N), np.int32)
        group_global = np.zeros(G, bool)
        for g, cap in enumerate(groups):
            group_cap[g, :n_live] = cap
            group_global[g] = groups_global[g]
        return {
            "task_volmask_w": task_volmask,   # [T, NW] u32
            "task_claims": task_claims,       # [T, C] bool
            "claim_group": claim_group,       # [C] i32
            "group_cap": group_cap,           # [G, N] i32
            "group_global": group_global,     # [G] bool
        }
